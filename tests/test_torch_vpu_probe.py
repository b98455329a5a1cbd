"""K6, the FP32 speed probes: the port's plain twins against a jnp restatement
of the TPU probe's kernel bodies (tools/vpu_probe.py:44-59, :78-95), at a
tiny element count with the probe's k_ops, chains and inner steps, and the
operation-count formulas (:72, :109). The JAX probe builds its Pallas kernel
inside the function, has no interpret switch and enables a compile cache at
import, so it is restated here rather than imported.

Tolerances: the mix chains are bit-equal (the same f32 adds in the same
order). The FMA chain of the port rounds once per step, as the card's FMA
does, where the TPU body rounds the multiply and the add apiece; over 512 to
1024 steps that drifts by ~1.2e-5 relative, so the FMA twin is held to rtol
5e-5 against the restated body and to rtol 1e-6 against a float64 chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu_torch.tools import vpu_probe as vp

N = 96  # elements: a tiny stand-in for the probe's 1,690,624


def jax_body(kind, chains, x, k_ops=vp.K_OPS, inner=vp.INNER):
    """The TPU probe's kernel body on a flat (N,) block `x`, as jnp ops."""
    a = jnp.asarray(x.numpy())

    def body(i, accs):
        for _ in range(inner):
            if kind == "fma":
                accs = tuple(acc * a + 1.0e-7 for acc in accs)
            else:
                accs = tuple(acc + jnp.where(a > 0.5, a, 0.0) for acc in accs)
        return accs

    accs = jax.lax.fori_loop(0, k_ops // (chains * inner), body,
                             tuple(a * (1.0 + 0.001 * c) for c in range(chains)))
    acc = accs[0]
    for c in range(1, chains):
        acc = acc + accs[c]
    return np.asarray(acc)


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("kind,chains", [("fma", 4), ("fma", 8), ("mix", 8)])
def test_twin_matches_tpu_body(kind, chains, spread):
    """On the TPU probe's constant input and on a seeded one spread across
    the mix's 0.5 (the select takes both sides)."""
    x = vp.spread_input("cpu", N) if spread else vp.probe_input("cpu", N)
    before = dict(vp.LAUNCHES)
    run = vp.fma_probe if kind == "fma" else vp.mix_probe
    ours = run(x, chains).numpy()
    assert vp.LAUNCHES == before  # CPU tensors run the twin
    ref = jax_body(kind, chains, x)
    assert np.isfinite(ours).all()
    if kind == "mix":
        np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
        if spread:  # some elements kept their seed, the others grew
            x0 = x.numpy()
            assert (x0 < 0.5).any() and (x0 > 0.5).any()
    else:
        np.testing.assert_allclose(ours, ref, rtol=5e-5, atol=0.0)


@pytest.mark.parametrize("chains", [4, 8])
def test_fma_twin_rounds_once(chains):
    """The FMA twin against the same chain in float64 with one f32 rounding
    per step, element by element over a few random inputs."""
    rng = np.random.default_rng(chains)
    xs = rng.uniform(0.9, 1.0, 16).astype(np.float32)
    ours = vp.fma_probe_ref(torch.as_tensor(xs), chains, k_ops=512).numpy()
    for i, a in enumerate(xs):
        acc = [np.float32(a * np.float32(1.0 + 0.001 * c)) for c in range(chains)]
        for _ in range(vp.trips(chains, 512) * vp.INNER):
            acc = [np.float32(np.float64(v) * np.float64(a) + np.float64(np.float32(1e-7)))
                   for v in acc]
        total = acc[0]
        for v in acc[1:]:
            total = np.float32(total + v)
        np.testing.assert_allclose(ours[i], total, rtol=1e-6)


def test_operation_counts():
    """The TPU probe's formulas: n (k_ops // chains) chains 2 for the FMA, 3
    for the mix; at the probe's shape and k_ops 4096."""
    n = vp.N_ELEMENTS
    assert n == 127 * 8 * 1664 == 1_690_624
    assert vp.fma_ops(n, 4) == vp.fma_ops(n, 8) == n * 4096 * 2 == 13_849_591_808
    assert vp.mix_ops(n) == n * 4096 * 3
    for chains in (4, 8):
        # the kernel's steps: trips of `inner` unrolled steps per chain
        assert vp.trips(chains) * vp.INNER * chains == 4096
    assert vp.fma_ops(10, 3, k_ops=100) == 10 * 33 * 3 * 2  # floor division, as :72


def test_wrapper_refuses_other_devices():
    x = torch.full((8,), 0.999, device="meta")
    with pytest.raises(ValueError):
        vp.fma_probe(x, 4)
    with pytest.raises(SystemExit):
        vp.measure("cpu")
