"""ImageFolder scan: ``root/<class>/*`` images, classes in sorted order.

The port's copy of ``deepfakedetection_tpu/data/folder.py``: classes are the
sorted child directory names (so fake = 0, real = 1) and samples the sorted
image paths of each class, as torchvision's ``ImageFolder``. A split
directory that holds ``*.tar`` files and no class directories scans as tar
shards (``data/shards.py``), whose dataset has the same surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp"}


@dataclass
class ImageFolderDataset:
    root: Path
    classes: list[str]
    class_to_idx: dict[str, int]
    samples: list[tuple[Path, int]] = field(repr=False)

    def __len__(self) -> int:
        return len(self.samples)


def scan_image_folder(root: str | Path):
    """``root/<class>/*`` as an ``ImageFolderDataset``, or ``root/*.tar`` as
    a ``data.shards.TarShardDataset`` when ``root`` has no class
    directories."""
    root = Path(root)
    if not root.is_dir():
        raise FileNotFoundError(f"dataset split directory not found: {root}")
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not classes and any(root.glob("*.tar")):
        from deepfakedetection_tpu_torch.data.shards import scan_tar_shards

        return scan_tar_shards(root)
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = [
        (p, class_to_idx[cls])
        for cls in classes
        for p in sorted((root / cls).rglob("*"))
        if p.is_file() and p.suffix.lower() in IMG_EXTENSIONS
    ]
    return ImageFolderDataset(root=root, classes=classes, class_to_idx=class_to_idx,
                              samples=samples)


def require_num_classes(
    dataset: ImageFolderDataset,
    expected: int,
    *,
    split: str,
    dataset_root: Path | str | None = None,
) -> None:
    """Exits with the reference's message when the split's class count is not
    ``expected``."""
    if expected <= 0:
        raise ValueError("expected number of classes must be positive")
    actual = len(dataset.classes)
    if actual == expected:
        return
    preview = ", ".join(dataset.classes[: min(5, actual)])
    if actual > 5:
        preview += ", …"
    root_hint = f" at {Path(dataset_root)}" if dataset_root is not None else ""
    raise SystemExit(
        f"Class count mismatch for split '{split}'{root_hint}: dataset "
        f"exposes {actual} classes ({preview}) but configuration sets "
        f"num_classes={expected}. Update config.data.num_classes (e.g., match "
        "it to the true number of categories in your ImageFolder)."
    )
