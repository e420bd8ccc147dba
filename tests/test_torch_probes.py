"""The port's developer probes P1 and P2 (gatling_tpu_torch/tools) on the CPU.

On the CPU each probe runs its plain twin; the CUDA kernels
(csrc/probes.cu) run on the card (tests/test_torch_cuda.py, chip_smoke.py
phase P). Held here:

1. P1's twins against the JAX probe's jax.numpy expressions
   (tools/mosaic_cast_probe.py) for the six layout moves, bit for bit, and
   the kernel's index map against the twins; the bank-conflict degree of
   each move's shared-memory reads, counted from that map;
2. P2's twins: the FP32 one-hot product equals jnp.dot at HIGHEST (x
   itself); `tf32_round` equals jax.lax.reduce_precision to 10 mantissa
   bits except at exact ties, which it rounds away from zero as
   cvt.rna.tf32.f32 does; the 3xTF32 split recovers x to 2^-21 relative;
3. both entry points' output on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatling_tpu_torch.tools import cast_probe, precision_probe

JNP_MOVES = (  # tools/mosaic_cast_probe.py's expressions, in MOVES' order
    lambda x: x.reshape(1024),
    lambda x: x.reshape(1024, 1),
    lambda x: jnp.stack([x.reshape(1024)] * 8, axis=-1),
    lambda x: jnp.concatenate([x.reshape(1024, 1)] * 8, axis=1),
    lambda x: x.T,
    lambda x: jnp.concatenate([x[i:i + 1].reshape(128, 1) for i in range(8)], axis=1),
)


@pytest.mark.parametrize("move", range(len(cast_probe.MOVES)))
def test_cast_twin_matches_jax_numpy(move):
    x = cast_probe.probe_input("cpu")
    ref = np.asarray(JNP_MOVES[move](jnp.asarray(x.numpy())))
    got = cast_probe.cast_moves(x)[move].numpy()  # the twins on a CPU tensor
    assert got.shape == ref.shape == cast_probe.MOVES[move][1]
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # the kernel's index map (csrc/probes.cu cast_src) reads the same words
    k = np.arange(got.size)
    np.testing.assert_array_equal(x.numpy().reshape(-1)[cast_probe.source_index(move, k)],
                                  got.reshape(-1))


def test_cast_bank_conflicts():
    """32 consecutive outputs a warp: the flat and stacked moves read
    distinct or broadcast words of distinct banks; a transpose's warp reads
    8 rows of 4 columns, which the kernel's row pitch of 132 words puts in
    32 distinct banks. Unpadded (a pitch of 128) those reads take 8 words
    in each of 4 banks."""
    assert cast_probe.STRIDE == 132
    assert [cast_probe.bank_conflicts(m) for m in range(6)] == [1] * 6
    assert [cast_probe.bank_conflicts(m, stride=128) for m in range(6)] == [1, 1, 1, 1, 8, 8]


def test_cast_probe_runs_on_the_cpu(capsys):
    results = cast_probe.run(torch.device("cpu"))
    out = capsys.readouterr().out
    assert all(ok for ok, _deg in results.values()) and len(results) == 6
    for name, _shape in cast_probe.MOVES:
        assert f"{name}: OK" in out


def test_precision_twins_match_jax_numpy():
    oh, x = precision_probe.probe_inputs("cpu")
    xn = x.numpy()
    ref = np.asarray(jnp.dot(jnp.asarray(oh.numpy()), jnp.asarray(xn),
                             precision=jax.lax.Precision.HIGHEST))
    fp32 = precision_probe.onehot_product(oh, x, 1).numpy()
    np.testing.assert_array_equal(fp32.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(fp32, xn)

    tf32 = precision_probe.onehot_product(oh, x, 0).numpy()
    np.testing.assert_array_equal(tf32, precision_probe.tf32_round(x).numpy())
    nearest_even = np.asarray(jax.lax.reduce_precision(jnp.asarray(xn), exponent_bits=8,
                                                       mantissa_bits=10))
    ties = (xn.view(np.int32) & 0x1FFF) == 0x1000
    np.testing.assert_array_equal(tf32[~ties], nearest_even[~ties])
    rel = np.abs(tf32 - xn).max() / np.abs(xn).max()
    assert 2.0 ** -13 < rel <= 2.0 ** -11  # TF32 keeps 10 mantissa bits

    split = precision_probe.onehot_product(oh, x, 2).numpy()
    assert np.abs(split - xn).max() / np.abs(xn).max() <= 2.0 ** -21


def test_tf32_round_ties_away_from_zero():
    """cvt.rna: a value halfway between two TF32 neighbours goes to the
    one of larger magnitude, on both signs; others to the nearest."""
    base = np.float32(1.0).view(np.int32)
    vals = np.array([base | 0x1000, base | 0x3000, base | 0x0FFF, base | 0x1001], np.int32)
    vals = np.concatenate([vals, vals | np.int32(-0x80000000)]).view(np.float32)
    got = precision_probe.tf32_round(torch.tensor(vals)).numpy().view(np.int32) & 0x7FFFFFFF
    want = np.array([base + 0x2000, base + 0x4000, base, base + 0x2000] * 2, np.int32)
    np.testing.assert_array_equal(got, want)
    assert (np.sign(precision_probe.tf32_round(torch.tensor(vals)).numpy())
            == np.sign(vals)).all()


def test_precision_probe_runs_on_the_cpu(capsys):
    results = precision_probe.run(torch.device("cpu"))
    out = capsys.readouterr().out
    assert set(results) == {name for name, _mode in precision_probe.MODES}
    assert all(same for *_e, same in results.values())
    assert results["HIGHEST (FP32)"][0] == 0.0 and results["DEFAULT (TF32)"][0] > 0.0
    for name, _mode in precision_probe.MODES:
        assert f"one-hot matmul {name}: max abs err" in out
