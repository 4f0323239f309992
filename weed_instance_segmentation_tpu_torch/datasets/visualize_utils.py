"""Shared drawing code of the per-dataset ground-truth viewers.

Port of ``weed_instance_segmentation_tpu/datasets/visualize_utils.py``.
matplotlib is imported only when a figure is drawn. Without a ``DISPLAY``
the figures are saved under ``config.OUTPUT_DIR/visualizations/`` instead of
shown.
"""

from __future__ import annotations

import os

import numpy as np

from weed_instance_segmentation_tpu_torch import config


def _plt():
    import matplotlib

    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    return plt


def show_or_save(fig, name: str, show: bool = True) -> None:
    plt = _plt()
    if show and os.environ.get('DISPLAY'):
        plt.show()
    else:
        out_dir = os.path.join(config.OUTPUT_DIR, 'visualizations')
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f'{os.path.splitext(name)[0]}_gt.png')
        fig.savefig(path)
        print(f'Saved visualization to {path}')
    plt.close(fig)


def overlay_semantic(image: np.ndarray, semantic: np.ndarray,
                     label_colors: dict, label_names: dict,
                     title: str, alpha: float = 0.5):
    """Image + per-class colored translucent overlay + legend."""
    plt = _plt()
    from matplotlib.patches import Patch

    color_mask = np.zeros((*semantic.shape, 3), np.uint8)
    present = []
    for label in np.unique(semantic):
        color = label_colors.get(int(label))
        if color is None or int(label) == 0:
            continue
        color_mask[semantic == label] = color
        present.append(int(label))

    blend = image.astype(np.float32)
    covered = (color_mask.sum(-1, keepdims=True) > 0)
    blend = np.where(covered, (1 - alpha) * blend + alpha * color_mask, blend)

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.imshow(blend.astype(np.uint8))
    ax.set_title(title)
    ax.axis('off')
    handles = [
        Patch(color=np.asarray(label_colors[lbl]) / 255.0, label=label_names.get(lbl, str(lbl)))
        for lbl in present
    ]
    if handles:
        ax.legend(handles=handles, loc='upper right')
    return fig


def overlay_polygons(image, polygons: list, title: str):
    """Image + colored polygon outlines. ``polygons`` is a list of
    (points Nx2, class_name, color)."""
    plt = _plt()
    from matplotlib.patches import Patch, Polygon

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.imshow(image)
    ax.set_title(title)
    ax.axis('off')
    legend: dict[str, object] = {}
    for points, class_name, color in polygons:
        patch = Polygon(points, closed=True, fill=True, alpha=0.35,
                        facecolor=color, edgecolor=color, linewidth=2)
        ax.add_patch(patch)
        legend.setdefault(class_name, Patch(color=color, label=class_name))
    if legend:
        ax.legend(handles=list(legend.values()), loc='upper right')
    return fig


def iter_limited(items):
    """Honor config.MAX_IMAGES like every reference visualizer."""
    if config.MAX_IMAGES is not None:
        return list(items)[: config.MAX_IMAGES]
    return list(items)
