"""chip_smoke.py's parts that run without a card: phase selection and
its options, the result line, the parity bound, and failing where there is
no GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as CS
from paf_baseband2power_tpu.runtime.pipeline import MODES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_runs_every_one_card_phase_in_order():
    assert CS.select_phases(False) == ["device", "modes", "cli", "gpu_tests"]


def test_four_cards_runs_only_its_phase():
    assert CS.select_phases(True) == ["four"]


@pytest.mark.parametrize("argv", [["--phase", "a"], ["--ndf", "64"],
                                  ["--nchk", "2"], ["--four-cards", "x"]])
def test_parent_takes_only_four_cards(argv, capsys):
    """The parent runs the full geometry and every phase: a subset or a
    reduced geometry is refused before any card is asked for."""
    with pytest.raises(SystemExit) as e:
        CS.main(argv)
    assert e.value.code == 2
    assert '"ok"' not in capsys.readouterr().out


def test_child_refuses_an_unknown_phase(capsys):
    with pytest.raises(SystemExit) as e:
        CS.main(["--child", "bogus"])
    assert e.value.code == 2
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = CS.result_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                           "count": count, "extra": 1})
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_parity_bound():
    want = np.array([100.0, -0.5, 1e-9])
    ok = CS.parity(want * (1 + 1e-6), want, rtol=1e-5, atol_rel=1e-6)
    assert ok["ok"] and ok["bound_ratio"] < 1
    bad = CS.parity(want + np.array([0.0, 0.01, 0.0]), want, rtol=1e-5,
                    atol_rel=1e-6)
    assert not bad["ok"] and bad["bound_ratio"] > 1
    assert not CS.parity(want[:2], want, 1e-5, 1e-6)["ok"]       # shape
    assert not CS.parity(want * np.nan, want, 1e-5, 1e-6)["ok"]


def test_fine_parity_holds_to_its_limit():
    """A fine-channel result using half of its bound (as implicit TF32
    matmuls do) passes the bound but fails the fine-mode limit."""
    want = np.array([1.0, 2.0, 4.0])
    half = want * (1 + 0.5 * CS.FINE_RTOL)
    assert CS.parity(half, want, CS.FINE_RTOL, 0.0)["ok"]
    res = CS.fine_parity(half, want)
    assert not res["ok"] and CS.FINE_LIMIT < res["bound_ratio"] < 1
    close = want * (1 + 0.01 * CS.FINE_RTOL)
    assert CS.fine_parity(close, want)["ok"]


def _no_result(stdout: str) -> bool:
    return '"ok"' not in stdout


def test_fails_without_a_card():
    """No nvidia-smi (no card): a non-zero exit and no result line."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert _no_result(r.stdout)


def test_fails_alone_in_a_directory(tmp_path):
    """chip_smoke.py without the rest of the repo fails and prints no
    result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert _no_result(r.stdout)


@pytest.fixture(scope="module")
def cell_blocks():
    """Two small blocks deep enough for every mode (nfft 1024 x 64
    spectra needs 2048 frames), on device in both layouts."""
    import jax

    from paf_baseband2power_tpu.ops.frame import block_to_rows, synthetic_block

    blocks = [synthetic_block(rng=i, ndf=2048, nchk=1) for i in range(2)]
    dev = {"wire": [jax.device_put(b.reshape(2048, -1)) for b in blocks],
           "rows": [jax.device_put(block_to_rows(b)) for b in blocks]}
    return blocks, dev


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("name", list(MODES))
def test_mode_cell_matches_golden(name, layout, cell_blocks):
    """Phase b's cell run and golden comparison for every mode x layout,
    at a reduced geometry on the CPU."""
    blocks, dev = cell_blocks
    kw = MODES[name]
    want = (CS.fine_golden(kw, blocks, 1) if kw.get("nfft")
            else CS.direct_golden(name, blocks[0]))
    cell = CS.run_cell(kw, layout, dev[layout], n_time=1)
    res, _ = CS.cell_parity(kw, cell["outs"], want, 1)
    assert res["ok"], res
    assert cell["step_sec"] > 0
