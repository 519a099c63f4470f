"""Port parity of ProteinMPNN (molchanica_tpu_torch.therapeutic.mpnn)
against molchanica_tpu's, on the CPU, in float64, both packages on the
port's init_weights (the JAX package's layout).

Tolerances:
- forward's log-probabilities (also on the JAX package's own init_weights
  carried over by params_from_jax), conditional_log_probs under the decoding
  order the JAX code draws from its key, and a greedy design's mean
  log-prob: 1e-10 (float64; other summation orders).
- knn_graph, the greedy design's sequence (temperature 1e-4 under the
  same order) and ddg_scan: exactly.
- The port's own design_sequences: each sample's mean log-prob equals the
  teacher-forced decode of its sequence under the same order, the 20
  residues renormalized (design masks X out of its softmax,
  conditional_log_probs does not), within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.therapeutic import mpnn as JM
from molchanica_tpu_torch.therapeutic import mpnn as TM

torch.set_num_threads(1)

K = 12


def _backbone(L, seed=0):
    """tests/test_mpnn.py's helix-like backbone, for both packages."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) * 100.0 * np.pi / 180.0
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(L)],
                  axis=1)
    n = ca + rng.normal(0, 0.1, (L, 3)) + [1.33, 0, -0.5]
    c = ca + rng.normal(0, 0.1, (L, 3)) + [-1.2, 0.4, 0.4]
    o = c + rng.normal(0, 0.05, (L, 3)) + [0.0, 1.23, 0]
    arrays = (n, ca, c, o, np.zeros(L, int), np.arange(L))
    return JM.Backbone(*arrays), TM.Backbone(*arrays)


@pytest.fixture(scope="module")
def params():
    """The port's init_weights in float64, and the same arrays for the
    JAX package."""
    p_t = TM.init_weights(torch.Generator().manual_seed(3),
                          dtype=torch.float64, device="cpu")
    return {k: jnp.asarray(v.numpy()) for k, v in p_t.items()}, p_t


def test_init_weights_layout(params):
    _, p_t = params
    # the JAX package's layout, traced without running its init
    ref = jax.eval_shape(lambda key: JM.init_weights(key, jnp.float64),
                         jax.random.PRNGKey(0))
    assert p_t.keys() == ref.keys()
    for k, v in p_t.items():
        assert tuple(v.shape) == ref[k].shape and v.dtype == torch.float64
        if k.endswith(".bias"):
            assert not v.any()
        elif "norm" in k:
            assert (v == 1).all()
        else:
            assert 0.5 < float(v.std()) * v.shape[-1] ** 0.5 < 1.5


def test_forward_matches_reference(params):
    p_j, p_t = params
    bb_j, bb_t = _backbone(20)
    lp_j = np.asarray(JM.forward(p_j, bb_j, k=K))
    lp_t = TM.forward(p_t, bb_t, k=K)
    assert lp_t.dtype == torch.float64 and lp_t.shape == (20, 21)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=0, atol=1e-10)
    bb = TM._bb_arrays(p_t, bb_t)
    np.testing.assert_array_equal(
        TM.knn_graph(bb[1], K).numpy(),
        np.asarray(JM.knn_graph(jnp.asarray(bb_j.ca), K)))
    wt = "ACDEFGHIKLMNPQRSTVWY"
    np.testing.assert_array_equal(TM.ddg_scan(torch.tensor(lp_j), wt),
                                  JM.ddg_scan(lp_j, wt))


def test_params_from_jax_into_forward():
    """The JAX package's own init_weights, carried over by params_from_jax,
    give the JAX package's forward."""
    p_j = JM.init_weights(jax.random.PRNGKey(5), jnp.float64)
    p_t = TM.params_from_jax(p_j, device="cpu")
    assert p_t.keys() == p_j.keys()
    for k, v in p_t.items():
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(p_j[k]))
    bb_j, bb_t = _backbone(20, seed=2)
    lp_j = np.asarray(JM.forward(p_j, bb_j, k=K))
    np.testing.assert_allclose(TM.forward(p_t, bb_t, k=K).numpy(), lp_j,
                               rtol=0, atol=1e-10)


def test_forward_normalized_and_rigid_invariant(params):
    _, p_t = params
    _, bb = _backbone(16, seed=1)
    lp = TM.forward(p_t, bb, k=10)
    np.testing.assert_allclose(lp.exp().sum(-1).numpy(), 1.0, atol=1e-12)
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    shift = np.array([11.0, -3.0, 7.0])
    bb2 = TM.Backbone(*(a @ R.T + shift for a in (bb.n, bb.ca, bb.c, bb.o)),
                      bb.chain_index, bb.residue_index)
    np.testing.assert_allclose(TM.forward(p_t, bb2, k=10).numpy(),
                               lp.numpy(), rtol=0, atol=1e-10)


def test_conditional_log_probs_under_the_reference_order(params):
    p_j, p_t = params
    bb_j, bb_t = _backbone(24)
    seq = "ACDEFGHIKLMNPQRSTVWYACDE"
    key = jax.random.PRNGKey(2)
    lp_j = JM.conditional_log_probs(p_j, bb_j, seq, key, k=K)
    order = np.asarray(jax.random.permutation(key, 24))
    enc = TM._encode(p_t, TM._bb_arrays(p_t, bb_t), K)
    idx, rows = TM._decode(p_t, enc, order,
                           sequence=[TM.ALPHABET.index(c) for c in seq])
    assert "".join(TM.ALPHABET[a] for a in idx.numpy()) == seq
    lp_t = rows.gather(1, idx[:, None])[:, 0].numpy()
    np.testing.assert_allclose(lp_t, lp_j, rtol=0, atol=1e-10)
    # the order's first steps alone decode those positions as the whole
    # order does, and leave the rest undecoded
    head = order[:10].tolist()
    idx_h, rows_h = TM._decode(p_t, enc, head,
                               sequence=[TM.ALPHABET.index(c) for c in seq])
    np.testing.assert_array_equal(rows_h[head].numpy(), rows[head].numpy())
    rest = np.setdiff1d(np.arange(24), head)
    assert not rows_h[rest].any() and not idx_h[rest].any()
    # the public entry point: its own order from a torch generator
    lp = TM.conditional_log_probs(p_t, bb_t, seq,
                                  torch.Generator().manual_seed(4), k=K)
    assert lp.shape == (24,) and np.isfinite(lp).all() and (lp <= 0).all()


def test_greedy_design_under_the_reference_order(params):
    p_j, p_t = params
    bb_j, bb_t = _backbone(24)
    key = jax.random.PRNGKey(1)
    seqs_j, lps_j = JM.design_sequences(p_j, bb_j, key, n_samples=2,
                                        temperature=1e-4, k=K)
    enc = TM._encode(p_t, TM._bb_arrays(p_t, bb_t), K)
    for s_j, lp_j in zip(seqs_j, lps_j):
        # design_sequences' key chain: a subkey per sample, whose first
        # split draws the order
        key, sub = jax.random.split(key)
        order = np.asarray(jax.random.permutation(jax.random.split(sub)[1],
                                                  24))
        idx, rows = TM._decode(p_t, enc, order,
                               gumbel=torch.zeros(24, 21, dtype=torch.float64),
                               temperature=1e-4)
        assert "".join(TM.ALPHABET[a] for a in idx.numpy()) == s_j
        lp = float(rows.gather(1, idx[:, None]).mean())
        assert abs(lp - lp_j) <= 1e-10


def test_design_sequences(params):
    _, p_t = params
    _, bb = _backbone(24)
    seqs, lps = TM.design_sequences(p_t, bb, torch.Generator().manual_seed(1),
                                    n_samples=2, temperature=0.5, k=K)
    assert len(seqs) == 2 and all(len(s) == 24 for s in seqs)
    assert all(c in TM.ALPHABET[:20] for s in seqs for c in s)   # no X
    seqs2, lps2 = TM.design_sequences(
        p_t, bb, torch.Generator().manual_seed(1), n_samples=2,
        temperature=0.5, k=K)
    assert seqs2 == seqs
    np.testing.assert_array_equal(lps2, lps)
    # each sample against the teacher-forced decode of its sequence under
    # the same order (design_sequences' draws, replayed)
    g = torch.Generator().manual_seed(1)
    enc = TM._encode(p_t, TM._bb_arrays(p_t, bb), K)
    for s, lp in zip(seqs, lps):
        order, _ = TM._draw(g, 24)
        idx, rows = TM._decode(p_t, enc, order.tolist(),
                               sequence=[TM.ALPHABET.index(c) for c in s])
        lp20 = torch.log_softmax(rows[:, :20], dim=-1)
        assert abs(float(lp20.gather(1, idx[:, None]).mean()) - lp) <= 1e-12
    fm = np.zeros(24, bool)
    fm[:5] = True
    pinned, _ = TM.design_sequences(p_t, bb, torch.Generator().manual_seed(2),
                                    temperature=0.5, k=K, fixed_mask=fm,
                                    fixed_seq="W" * 24)
    assert pinned[0][:5] == "WWWWW"
    # a mask without a sequence pins index 0 ('A'), as the reference does
    pinned, _ = TM.design_sequences(p_t, bb, torch.Generator().manual_seed(2),
                                    temperature=0.5, k=K, fixed_mask=fm)
    assert pinned[0][:5] == "AAAAA"


def test_mpnn_entry_points_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_weights(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.params_from_jax({"w_out.weight": np.zeros((21, 128))})
