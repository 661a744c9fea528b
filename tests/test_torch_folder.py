"""The port's ImageFolder scan (deepfakedetection_tpu_torch/data/folder.py):
class directories in sorted order, and a split kept as tar shards scanned as
shards (``data/shards.py``)."""

from deepfakedetection_tpu_torch.data.folder import ImageFolderDataset, scan_image_folder
from deepfakedetection_tpu_torch.data.shards import TarShardDataset, write_shards


def test_tar_shards_scan_as_shards(tmp_path):
    tree = tmp_path / "tree"
    for cls in ("real", "fake"):
        (tree / cls).mkdir(parents=True)
        (tree / cls / "a.jpg").write_bytes(cls.encode())
    split = tmp_path / "train"
    write_shards(scan_image_folder(tree), split)
    ds = scan_image_folder(split)
    assert isinstance(ds, TarShardDataset) and ds.classes == ["fake", "real"]
    assert ds.samples == [("fake/a.jpg", 0), ("real/a.jpg", 1)] and ds.read_bytes(1) == b"real"
    (split / "real").mkdir()  # a class directory: the folder layout wins, as in JAX
    assert isinstance(scan_image_folder(split), ImageFolderDataset)


def test_class_folders_scan_in_sorted_order(tmp_path):
    for cls in ("real", "fake"):
        (tmp_path / cls).mkdir()
        (tmp_path / cls / "a.jpg").write_bytes(b"")
    (tmp_path / "fake" / "notes.txt").write_bytes(b"")
    ds = scan_image_folder(tmp_path)
    assert ds.classes == ["fake", "real"] and [label for _, label in ds.samples] == [0, 1]
