"""The port's entry points (``fdeflate_tpu_torch/entry_points.py``) against
``__graft_entry__.py``.

``entry_v1`` runs XLA in JAX on the CPU, so its outputs are held to JAX's;
``entry``'s JAX step runs interpret-mode Pallas, so in the default tier
its sums are held to the port's ``fused_ultrafast_roundtrip_v2`` (held to
JAX by test_torch_blocked.py) and its example arguments to JAX's, and the
``slow`` tier holds its sums to JAX's own.
``dryrun_multichip(4, device="cpu")`` spawns a world of 4 gloo processes,
the counterpart of JAX's re-run on 4 virtual CPU devices.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from fdeflate_tpu_torch import entry_points as E
from fdeflate_tpu_torch.parallel.device_pipeline import (
    fused_ultrafast_roundtrip_v2,
)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's torch work: the tier runs
    several workers and spawned ranks on a few cores, where torch's
    threads spin against each other (the per-shard oracles took ~60x
    their single-process time with the default count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("name", ["entry", "entry_v1"])
def test_example_arguments_equal_jax(name):
    _fn, (data, lengths) = getattr(G, name)()
    _step, (pd, pl) = getattr(E, name)(device="cpu")
    np.testing.assert_array_equal(pd.numpy(), np.asarray(data))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(lengths))


def test_entry_sums_equal_the_port_step():
    """The sum of the decoded words (int32, wrapping as JAX's ``jnp.sum``
    of int32 does) and the counts of both checks."""
    fwd, (data, lengths) = E.entry(device="cpu")
    total, bpos_ok, ck_ok = fwd(data, lengths)
    out, want_bpos, want_ck = fused_ultrafast_roundtrip_v2(
        8, N=4096, U=32, device="cpu")(data, lengths)
    assert torch.equal(out, data)
    words = out.numpy().view("<i4").astype(np.int64).sum()
    assert total.dtype == torch.int32
    assert int(total) == int(np.int64(words).astype(np.int32))
    assert int(bpos_ok) == int(want_bpos.sum()) == 4
    assert int(ck_ok) == int(want_ck.sum()) == 4


@pytest.mark.slow  # JAX's step runs its Pallas kernels in interpret mode here
def test_entry_sums_equal_jax():
    """``entry``'s three sums on JAX's example against ``__graft_entry__``'s,
    run on the CPU."""
    fwd, (data, lengths) = G.entry()
    want = [int(x) for x in jax.jit(fwd)(data, lengths)]
    pfwd, (pd, pl) = E.entry(device="cpu")
    assert [int(x) for x in pfwd(pd, pl)] == want


def test_entry_v1_equals_jax():
    step, (data, lengths) = G.entry_v1()
    opos, status, adler = (np.asarray(x) for x in
                           jax.jit(step)(data, lengths))
    pstep, (pd, pl) = E.entry_v1(device="cpu")
    got = pstep(pd, pl)
    np.testing.assert_array_equal(got[0].numpy(), opos)
    np.testing.assert_array_equal(got[1].numpy().astype(np.int64), status)
    np.testing.assert_array_equal(got[2].numpy(), adler.astype(np.int64))
    assert (opos == 256).all() and (status == 1).all()


def test_dryrun_multichip_on_a_gloo_world():
    """Every sharded step asserts its result on a (2, 2) mesh of 4 gloo
    processes; a failing rank's traceback would surface here."""
    E.dryrun_multichip(4, device="cpu")


DEFAULT_DEVICE_CALLS = {
    "entry": lambda: E.entry(),
    "entry_v1": lambda: E.entry_v1(),
    "dryrun_multichip(1)": lambda: E.dryrun_multichip(1),
    "dryrun_multichip(4)": lambda: E.dryrun_multichip(4),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Without CUDA the default ``device="cuda"`` raises; nothing falls
    back to the CPU or to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[name]()
