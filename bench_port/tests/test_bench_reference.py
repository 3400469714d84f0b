"""The reference judges only what a run may be held to: no pair or span of
frames that straddles one left out, and each event's relocalization by the
motion from the last frame before its cover."""

import numpy as np
import pytest

from bench_port import reference


def test_spans_straddle_no_frame_left_out():
    window = np.array([0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1], dtype=bool)
    a, b = reference.spans_of(window, 1)
    assert list(zip(a, b)) == [(1, 2), (2, 3), (5, 6), (6, 7), (7, 8),
                               (8, 9), (9, 10), (10, 11)]
    a, b = reference.spans_of(window, 5)
    assert list(zip(a, b)) == [(5, 10), (6, 11)]
    # A window with none left out keeps every pair, as it always did.
    a, b = reference.spans_of(np.ones(8, dtype=bool), 5)
    assert list(zip(a, b)) == [(0, 5), (1, 6), (2, 7)]


def turn(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("error", [0.0, 0.05])
def test_a_relocalization_is_judged_by_its_motion(error):
    R = np.stack([turn(0.1 * i) for i in range(6)])
    t = np.array([[0.2 * i, 0.0, 1.0] for i in range(6)])
    # The estimate: another frame and scale, and the recovered frame (4)
    # turned by ``error``.
    g, s = turn(0.3), 2.0
    R_est = R @ g.T
    t_est = s * t
    R_est[4] = turn(error) @ R_est[4]
    t_est[4] = turn(error) @ t_est[4]
    out = reference._reloc(R_est, t_est, R, t,
                           dict(pairs=[(1, 4)], unrecovered=2), 0.0)
    assert out["unrecovered"] == 2
    assert out["reloc_rel_rot_max"] == pytest.approx(error, abs=1e-9)
    assert (out["reloc_rel_dir_max"] > 0.01) == (error > 0)


def test_a_run_with_no_recovery_has_no_relocalization_numbers():
    R = np.stack([np.eye(3)] * 3)
    t = np.zeros((3, 3))
    out = reference._reloc(R, t, R, t, dict(pairs=[], unrecovered=3), 0.0)
    assert out == {"unrecovered": 3.0}


def test_a_number_with_nothing_to_compare_is_left_out():
    """A window whose judged frames hold no pair and no span: its numbers
    are left out (and a run missing them is not correct), not an error."""
    from types import SimpleNamespace
    n = 8
    R = np.stack([turn(0.1 * i) for i in range(n)])
    t = np.zeros((n, 3))
    seq = SimpleNamespace(
        index=lambda k: k, R=R, t=t,
        path=SimpleNamespace(centers=np.ones((n, 3))),
        frames=np.zeros((n, 16, 16), dtype=np.uint8))
    window = np.zeros(n, dtype=bool)
    window[[1, 3, 5]] = True
    out = reference.judge(seq, np.arange(n), R, t, np.zeros(n, dtype=bool),
                          window, R[:1], t[:1], np.zeros((1, 24, 16)),
                          np.zeros((0, 3)))
    assert "rel_rot_max" not in out and "rel_dir_max" not in out
