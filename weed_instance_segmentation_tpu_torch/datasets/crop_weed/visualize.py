"""crop_weed ground-truth viewer: the PNG or the YAML implementation, chosen
when the module is imported from ``definitions.ANNOTATION_FORMAT``.

Port of ``weed_instance_segmentation_tpu/datasets/crop_weed/visualize.py``.
"""

from weed_instance_segmentation_tpu_torch.datasets.crop_weed.definitions import ANNOTATION_FORMAT

if ANNOTATION_FORMAT == 'png':
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed.annotation_dependent_implementations.visualize_png_annotations import (  # noqa: F401
        visualize_dataset,
    )
elif ANNOTATION_FORMAT == 'yaml':
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed.annotation_dependent_implementations.visualize_yaml_annotations import (  # noqa: F401
        visualize_dataset,
    )
else:
    raise ValueError(
        f'Unknown ANNOTATION_FORMAT "{ANNOTATION_FORMAT}" in crop_weed definitions. '
        f'Supported formats are "png" and "yaml".'
    )

if __name__ == '__main__':
    visualize_dataset()
