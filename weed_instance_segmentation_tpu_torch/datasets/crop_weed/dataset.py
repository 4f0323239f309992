"""crop_weed reader: the PNG or the YAML implementation, chosen when the
module is imported from ``definitions.ANNOTATION_FORMAT``.

Port of ``weed_instance_segmentation_tpu/datasets/crop_weed/dataset.py``."""

from weed_instance_segmentation_tpu_torch.datasets.crop_weed.definitions import ANNOTATION_FORMAT

if ANNOTATION_FORMAT == 'png':
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed.annotation_dependent_implementations.dataset_from_png_annotations import (  # noqa: F401
        CropWeedDataset,
    )
elif ANNOTATION_FORMAT == 'yaml':
    from weed_instance_segmentation_tpu_torch.datasets.crop_weed.annotation_dependent_implementations.dataset_from_yaml_annotations import (  # noqa: F401
        CropWeedDataset,
    )
else:
    raise ValueError(
        f'Unknown ANNOTATION_FORMAT "{ANNOTATION_FORMAT}" in crop_weed definitions. '
        f'Supported formats are "png" and "yaml".'
    )
