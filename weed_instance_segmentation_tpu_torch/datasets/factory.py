"""Dataset lookup by name.

Port of ``weed_instance_segmentation_tpu/datasets/factory.py``: for a dataset
name, import ``weed_instance_segmentation_tpu_torch.datasets.<name>.definitions``
and ``...<name>.dataset`` and return the class named ``<Name>Dataset``
(``name.title().replace('_', '')``) with the definitions module.
"""

import importlib

_PKG = 'weed_instance_segmentation_tpu_torch.datasets'


def get_dataset_and_config(dataset_name: str):
    """``(DatasetClass, definitions_module)`` of ``dataset_name``."""
    modules = []
    for part in ('definitions', 'dataset'):
        path = f'{_PKG}.{dataset_name}.{part}'
        try:
            modules.append(importlib.import_module(path))
        except ImportError:
            raise ValueError(f'no {part} module for dataset {dataset_name!r} — '
                             f'expected an importable "{path}"') from None
    config_module, dataset_module = modules
    class_name = dataset_name.title().replace('_', '') + 'Dataset'
    if not hasattr(dataset_module, class_name):
        raise ValueError(f'no dataset class for dataset {dataset_name!r} — expected '
                         f'"{dataset_module.__name__}" to define {class_name}')
    return getattr(dataset_module, class_name), config_module
