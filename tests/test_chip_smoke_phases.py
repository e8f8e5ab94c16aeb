"""chip_smoke.py's phase functions at a tiny width on the CPU: the same code
the GPU run executes, with the CPU standing in for the card."""

import pytest

import chip_smoke

TINY_CFG = """MODEL:
  TYPE: cswin
  NAME: cswin_test_tiny
  DROP_PATH_RATE: 0.1
  PRETRAIN_CKPT: ""
  CSWIN:
    EMBED_DIM: 16
    DEPTH: [1, 1, 1, 1]
    NUM_HEADS: [2, 2, 4, 8]
    SPLIT_SIZE: [1, 2, 2, 1]
"""


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("smoke") / "tiny.yaml"
    path.write_text(TINY_CFG)
    return str(path)


@pytest.fixture(scope="module")
def trained(cfg, tmp_path_factory):
    work = tmp_path_factory.mktemp("smoke_train")
    return chip_smoke.phase_train(cfg, str(work), 0, img=32, batch=4,
                                  n_slices=8, epochs=6)


def test_phase_forward(cfg, capsys):
    chip_smoke.phase_forward(cfg, 32, 2, 0, base_cfg_path=cfg, base_img=32,
                             base_batch=2)
    out = capsys.readouterr().out
    assert "FAIL" not in out
    assert "bf16 vs f32-highest logits rel L2" in out
    assert "vs cpu f32 at depth (1,1,1,1)" in out


def test_phase_train(trained):
    model, params = trained
    assert "stage1_0" in params["params"]["backbone"]


def test_phase_eval(trained, capsys):
    model, params = trained
    chip_smoke.phase_eval(model, params, 0, img=32, size=48, depths=(3, 5))
    out = capsys.readouterr().out
    assert "idx 0 case case0000 mean_dice" in out
    assert out.count("device vs host metrics") == 4


def test_phase_four_on_four_cpu_devices(cfg, capsys):
    chip_smoke.phase_four(0, cfg_path=cfg, img=32, batch=8, depth=16, n=4)
    out = capsys.readouterr().out
    assert out.count("[chip_smoke] ok") == 3
