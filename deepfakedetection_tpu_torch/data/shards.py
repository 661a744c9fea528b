"""Tar shards: a split kept as ``*.tar`` files, for data sets of many files.

The port's copy of ``deepfakedetection_tpu/data/shards.py``, the same layout:

- a split is a directory of ``*.tar`` files whose members are named
  ``<class>/<relative path>``; the class is the member's first directory and
  classes are in sorted order, as the folder scan orders them (fake = 0,
  real = 1);
- ``scan_tar_shards`` indexes every member once from the tar headers (name,
  payload offset, size; nothing is decoded or extracted), so a sample is
  read by one seek and one read (``read_bytes``);
- the dataset hands out encoded bytes; the loader decodes them in its own
  pool (``data/pipeline.Loader``: the native library's buffer decode, or
  PIL from memory), so shuffling, padding and ``cache_decoded`` are those
  of a folder split;
- ``write_shards`` packs a folder split into shards, in the folder scan's
  order, so a packed split scans to the same samples in the same order.

``data/folder.scan_image_folder`` takes a split directory that holds
``*.tar`` files and no class directories as shards. Pack a tree with::

    python -m deepfakedetection_tpu_torch.data.shards --root DATA --out SHARDS \\
        [--splits train val test] [--images-per-shard 1000]

which writes ``SHARDS/<split>/shard-00000.tar``...; point ``data.root`` at
``SHARDS`` afterwards.
"""

from __future__ import annotations

import argparse
import tarfile
from dataclasses import dataclass, field
from pathlib import Path

from deepfakedetection_tpu_torch.data.folder import (
    IMG_EXTENSIONS,
    ImageFolderDataset,
    scan_image_folder,
)


@dataclass(frozen=True)
class TarMember:
    """Where one image member's bytes lie in its shard."""

    shard: int  # index into TarShardDataset.shards
    offset: int  # the payload's byte offset in the shard file
    size: int  # the payload's length in bytes


@dataclass
class TarShardDataset:
    """A split kept as tar shards: the folder dataset's ``classes``,
    ``class_to_idx``, ``samples`` (member name, label) and length, and
    ``read_bytes``, by which the loader knows to decode from bytes."""

    root: Path
    shards: list[Path]
    classes: list[str]
    class_to_idx: dict[str, int]
    samples: list[tuple[str, int]] = field(repr=False)
    members: list[TarMember] = field(repr=False)

    def __len__(self) -> int:
        return len(self.samples)

    def read_bytes(self, index: int) -> bytes:
        """The encoded bytes of sample ``index``: one seek and one read. The
        shard is opened for each call, so the loader's threads share
        nothing."""
        m = self.members[index]
        with self.shards[m.shard].open("rb") as f:
            f.seek(m.offset)
            data = f.read(m.size)
        if len(data) != m.size:
            raise OSError(f"short read ({len(data)}/{m.size} bytes) for member "
                          f"'{self.samples[index][0]}' in {self.shards[m.shard]}")
        return data


def scan_tar_shards(root: str | Path) -> TarShardDataset:
    """Indexes ``root/*.tar``: classes in sorted order, samples by class and
    then member name, as the folder scan orders a tree packed by
    ``write_shards``. Members without a class directory or an image
    extension are left out."""
    root = Path(root)
    shards = sorted(root.glob("*.tar"))
    if not shards:
        raise FileNotFoundError(f"no *.tar shards found in: {root}")
    classes: set[str] = set()
    rows: list[tuple[str, str, TarMember]] = []  # (class, member name, where)
    for si, shard in enumerate(shards):
        with tarfile.open(shard, "r") as tf:  # reads the headers, not the payloads
            for info in tf:
                if not info.isfile():
                    continue
                name = info.name.lstrip("./")
                if "/" not in name or Path(name).suffix.lower() not in IMG_EXTENSIONS:
                    continue
                cls = name.split("/", 1)[0]
                classes.add(cls)
                rows.append((cls, name, TarMember(si, info.offset_data, info.size)))
    ordered = sorted(classes)
    class_to_idx = {c: i for i, c in enumerate(ordered)}
    rows.sort(key=lambda r: (class_to_idx[r[0]], r[1]))
    return TarShardDataset(
        root=root, shards=shards, classes=ordered, class_to_idx=class_to_idx,
        samples=[(name, class_to_idx[cls]) for cls, name, _ in rows],
        members=[m for _, _, m in rows],
    )


def write_shards(dataset: ImageFolderDataset, out_dir: str | Path, *,
                 images_per_shard: int = 1000) -> list[Path]:
    """Packs a folder split into ``out_dir/shard-00000.tar``... of
    ``images_per_shard`` members each, in the dataset's sample order, as
    ``<class>/<path under the class directory>``, uncompressed (the images
    are compressed already, and a plain tar stays seekable)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    idx_to_class = {i: c for c, i in dataset.class_to_idx.items()}
    written: list[Path] = []
    tf: tarfile.TarFile | None = None
    try:
        for i, (path, label) in enumerate(dataset.samples):
            if i % images_per_shard == 0:
                if tf is not None:
                    tf.close()
                written.append(out_dir / f"shard-{len(written):05d}.tar")
                tf = tarfile.open(written[-1], "w")
            cls = idx_to_class[label]
            try:  # nested paths stay unique within a class (the folder scan recurses)
                rel = Path(path).relative_to(dataset.root / cls).as_posix()
            except ValueError:
                rel = Path(path).name
            tf.add(path, arcname=f"{cls}/{rel}", recursive=False)
    finally:
        if tf is not None:
            tf.close()
    return written


def main(argv: list[str] | None = None) -> None:
    """Packs each split of a folder tree, as ``tools/make_shards.py`` does."""
    parser = argparse.ArgumentParser(description="Pack ImageFolder splits into tar shards.")
    parser.add_argument("--root", type=Path, required=True, help="ImageFolder dataset root")
    parser.add_argument("--out", type=Path, required=True, help="output root for shards")
    parser.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    parser.add_argument("--images-per-shard", type=int, default=1000)
    args = parser.parse_args(argv)
    for split in args.splits:
        split_dir = args.root / split
        if not split_dir.is_dir():
            print(f"skipping missing split: {split_dir}")
            continue
        ds = scan_image_folder(split_dir)
        shards = write_shards(ds, args.out / split, images_per_shard=args.images_per_shard)
        print(f"{split}: {len(ds)} images ({len(ds.classes)} classes) → "
              f"{len(shards)} shard(s) in {args.out / split}")


if __name__ == "__main__":
    main()
