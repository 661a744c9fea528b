"""The port's ImageFolder scan (deepfakedetection_tpu_torch/data/folder.py):
a split kept as tar shards, which the port does not read yet, raises before
any work and names its ROADMAP item."""

import pytest

from deepfakedetection_tpu_torch.data.folder import scan_image_folder


def test_tar_shards_refuse_naming_their_item(tmp_path):
    split = tmp_path / "train"
    split.mkdir()
    (split / "shard-000000.tar").write_bytes(b"")
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 13\)"):
        scan_image_folder(split)


def test_class_folders_scan_in_sorted_order(tmp_path):
    for cls in ("real", "fake"):
        (tmp_path / cls).mkdir()
        (tmp_path / cls / "a.jpg").write_bytes(b"")
    (tmp_path / "fake" / "notes.txt").write_bytes(b"")
    ds = scan_image_folder(tmp_path)
    assert ds.classes == ["fake", "real"] and [label for _, label in ds.samples] == [0, 1]
