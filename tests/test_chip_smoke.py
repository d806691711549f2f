"""chip_smoke.py's phases at scale 10 on the CPU: the script's control
flow, generators and comparisons run here; on the card the same functions
run at GAP scale (see the module docstring)."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


@pytest.mark.parametrize("phase", sorted(CS.PHASES))
def test_phase_small(phase):
    recs = CS.run(CS.SMALL, [phase])
    assert recs, "phase produced no checks"
    bad = [r for r in recs if not r["ok"]]
    assert not bad, bad
    timed = [r for r in recs if "time_s" in r]
    assert timed and all(r["time_s"] >= 0 <= r["first_s"] for r in timed)


def test_dist_phase_small():
    """The --devices 4 path on four of the virtual CPU devices."""
    recs = CS.run(CS.SMALL, ["dist"])
    bad = [r for r in recs if not r["ok"]]
    assert recs and not bad, bad


def test_failed_check_is_reported():
    recs = []
    sm = CS.Smoke(CS.SMALL, recs.append)
    assert not sm.check("x", "y", 1.0, 0.5)
    assert not sm.check("x", "nan", float("nan"), 0.5)
    assert sm.check("x", "z", 0.0, 0.0)
    assert [r["ok"] for r in recs] == [False, False, True]


def test_phase_exception_is_recorded(monkeypatch):
    def boom(sm):
        raise RuntimeError("boom")
    monkeypatch.setitem(CS.PHASES, "dense", boom)
    recs = CS.run(CS.SMALL, ["dense"])
    assert len(recs) == 1 and not recs[0]["ok"]
    assert "boom" in recs[0]["error"]


def test_main_refuses_without_gpu(capsys):
    assert CS.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_kron_generator_is_seeded_and_skewed():
    import jax
    k = jax.random.key(1)
    r1, c1, w1 = CS.kron_edges(k, 12, 16)
    r2, c2, w2 = CS.kron_edges(k, 12, 16)
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
    r = np.asarray(r1)
    assert r.min() >= 0 and r.max() < 1 << 12
    w = np.asarray(w1)
    assert (w > 0).all() and (w <= 1).all()
    deg = np.bincount(r, minlength=1 << 12)
    # Kronecker graphs are skewed: the top vertex has far more than the
    # mean degree of 16; uniform graphs do not
    assert deg.max() > 20 * 16
    ru, _, _ = CS.urand_edges(k, 12, 16)
    assert np.bincount(np.asarray(ru)).max() < 4 * 16
