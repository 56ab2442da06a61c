"""The port's entry points (rsba_tpu_torch.entry) against
``__graft_entry__``.

``entry()`` returns one LM iteration on the tiny flagship through the
banded window solver; in float32 on the CPU its cost, decrease,
predicted decrease and new parameters must match the reference's
``entry()`` step (the XLA window engine) at float32 tolerance.  The
rank body of ``dryrun_multichip`` runs in tests/test_torch_dist.py's
world of 4 gloo ranks, which that file's tests read.
"""
import numpy as np
import pytest
import torch

import __graft_entry__
from rsba_tpu_torch import entry

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def test_entry_step_matches_reference():
    """Same inputs (the two generators agree in float32 to round-off),
    then one LM step each: cost rtol 1e-5, decrease and predicted
    decrease rtol 1e-3, new poses and points rtol 1e-3 atol 1e-4 (float32
    through 25 CG iterations; the CG count within 2)."""
    jfn, (jp0, jradius) = __graft_entry__.entry()
    tfn, (tp0, tradius) = entry.entry(device="cpu")
    for f in ("q", "c", "intr", "points"):
        np.testing.assert_allclose(_np(getattr(tp0, f)),
                                   np.asarray(getattr(jp0, f)),
                                   rtol=1e-6, atol=1e-6)
    assert float(tradius) == float(jradius)
    jp, (jcost, jdec, jpred, jcg) = jfn(jp0, jradius)
    tp, (tcost, tdec, tpred, tcg) = tfn(tp0, tradius)
    assert tp.points.dtype == torch.float32
    np.testing.assert_allclose(_np(tcost), np.asarray(jcost), rtol=1e-5)
    np.testing.assert_allclose(_np(tdec), np.asarray(jdec), rtol=1e-3)
    np.testing.assert_allclose(_np(tpred), np.asarray(jpred), rtol=1e-3)
    assert abs(int(tcg) - int(jcg)) <= 2
    assert float(tdec) > 0            # the step is accepted and descends
    for f in ("q", "c", "points"):
        np.testing.assert_allclose(_np(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)),
                                   rtol=1e-3, atol=1e-4)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry.entry()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry.dryrun_multichip(2)
