"""The config reader's YAML subset: same result as PyYAML on every shipped
config, BASE inheritance, and an error that names file and line."""

import glob
import os

import pytest

from cswin_unet_tpu.config import YamlSubsetError, get_config, load_yaml

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cswin_unet_tpu", "configs", "*.yaml")))


def test_five_configs_shipped():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_reader_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        assert load_yaml(path) == yaml.safe_load(f)


def test_base_inheritance_and_scalars(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "MODEL:\n  DROP_PATH_RATE: 0.5  # a comment\n  CSWIN:\n"
        "    DEPTH:\n      - 2\n      - 4\n    QK_SCALE: ~\n"
        "DATA:\n  IMG_SIZE: 384\n  DATASET: 'synapse # not a comment'\n")
    (tmp_path / "child.yaml").write_text(
        "BASE: ['base.yaml']\nMODEL:\n  DROP_PATH_RATE: 1.0e-1\n"
        "TRAIN:\n  USE_CHECKPOINT: yes\n")
    args = type("A", (), {"cfg": str(tmp_path / "child.yaml"), "opts": None})()
    c = get_config(args)
    assert c.MODEL.DROP_PATH_RATE == 0.1            # child overrides base
    assert c.MODEL.CSWIN.DEPTH == [2, 4]            # block list from base
    assert c.MODEL.CSWIN.QK_SCALE is None
    assert c.DATA.IMG_SIZE == 384
    assert c.DATA.DATASET == "synapse # not a comment"
    assert c.TRAIN.USE_CHECKPOINT is True           # YAML 1.1 bool
    assert c.MODEL.CSWIN.EMBED_DIM == 64            # default untouched


def test_construct_outside_subset_names_file_and_line(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("MODEL:\n  NAME: x\n  CSWIN: &anchor\n    EMBED_DIM: 8\n")
    with pytest.raises(YamlSubsetError, match=r"bad\.yaml:3"):
        load_yaml(str(path))
