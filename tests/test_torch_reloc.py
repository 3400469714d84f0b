"""Relocalization: the PyTorch port's ``attempt_recovery`` against the JAX
package's on tests/test_reloc.py's scene (320x240, seed 9, radius 0.4,
sweep 1.5; frames 0, 5 and 10 as keyframes 0-2 of a 4-slot map), built
with the JAX package and handed to the port as numpy.

Its three cases: frame 6 (nearest keyframe 1), keyframe 0's own SBI, and
frame 6 with keyframe 1 invalid. Bars: the same best keyframe and
success; the ESM score within a relative 1e-5 (1e-3 absolute for the
near-zero score of a keyframe's own SBI); the proposed pose within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptam_cg_tpu.io import synth
from ptam_cg_tpu.models import keyframe, map_state, relocalizer
from ptam_cg_tpu_torch.io import from_jax as fj
from ptam_cg_tpu_torch.models import relocalizer as treloc

torch.set_num_threads(2)

REF_PARAMS = (1.0803, 1.43987, 0.519983, 0.548655, 0.244943)
SIZE = (320, 240)
SBI_SIZE = (15, 20)


@pytest.fixture(scope="module")
def setup():
    seq = synth.SyntheticSequence(REF_PARAMS, image_size=SIZE, n_frames=12,
                                  seed=9, height=1.5, radius=0.4, sweep=1.5)
    build = jax.jit(lambda x: keyframe.build_frame(
        x, candidate_min_score=70.0))
    m = map_state.empty_map(SIZE, max_points=64, max_kfs=4)
    ffs = []
    for i, fidx in enumerate([0, 5, 10]):
        ff = build(seq.frame(fidx))
        m = map_state.insert_keyframe(m, i, ff, seq.pose(fidx))
        ffs.append(ff)
    return m, ffs, build(seq.frame(6))


def _cases(setup):
    m, ffs, ff6 = setup
    return {"frame 6": (m, ff6.sbi, 1),
            "keyframe 0": (m, ffs[0].sbi, 0),
            "keyframe 1 invalid": (m._replace(
                kf_valid=m.kf_valid.at[1].set(False)), ff6.sbi, None)}


@pytest.mark.parametrize("case", ["frame 6", "keyframe 0",
                                  "keyframe 1 invalid"])
def test_attempt_recovery_matches_jax(setup, case):
    m, sbi, want_kf = _cases(setup)[case]
    params = jnp.asarray(REF_PARAMS, jnp.float32)
    j = jax.jit(relocalizer.attempt_recovery, static_argnums=3)(
        m, sbi, params, SBI_SIZE)
    t = treloc.attempt_recovery(
        fj.map_state_from_numpy(fj.as_numpy_tree(m), "cpu"),
        fj.sbi_from_numpy(fj.as_numpy_tree(sbi), "cpu"),
        torch.tensor(REF_PARAMS, dtype=torch.float32), SBI_SIZE)
    assert int(t.best_kf) == int(j.best_kf)
    if want_kf is None:
        assert int(t.best_kf) != 1
    else:
        assert int(t.best_kf) == want_kf
    assert bool(t.success) == bool(j.success)
    np.testing.assert_allclose(float(t.score), float(j.score), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(t.pose.R.numpy(), np.asarray(j.pose.R),
                               atol=1e-5)
    np.testing.assert_allclose(t.pose.t.numpy(), np.asarray(j.pose.t),
                               atol=1e-5)
