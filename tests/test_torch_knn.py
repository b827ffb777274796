"""Port parity: the K4 twin (stratified kNN), the kNN graphs and the GCN
eval forward vs rnr_tpu."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnr_tpu.models.gcn import DenseDeepGCN as JaxGCN
from rnr_tpu.models.gcn import GCNConfig as JaxGCNConfig
from rnr_tpu.models.gcn import knn_graph as jax_knn_graph
from rnr_tpu.models.gcn import sample_strata as jax_sample_strata
from rnr_tpu.ops.knn_pallas import stratified_knn as jax_stratified_knn
from rnr_tpu_torch.convert import load_jax_variables
from rnr_tpu_torch.models.gcn import (DenseDeepGCN, GCNConfig, knn_graph,
                                      pairwise_distance, sample_strata)
from rnr_tpu_torch.ops.knn_cuda import (compare_picks, knn_work_bytes,
                                        score_bound, stratified_knn,
                                        stratified_knn_torch)

torch.set_num_threads(2)


@pytest.mark.parametrize("v,c", [(700, 3), (1024, 64)])
def test_stratified_twin_matches_jax_interpret(v, c):
    x = np.random.default_rng(v).standard_normal((v, c)).astype(np.float32)
    want = np.asarray(jax_stratified_knn(jnp.asarray(x), stratum=16,
                                         row_tile=128, col_tile=512,
                                         interpret=True))
    got = stratified_knn(torch.from_numpy(x), 16).numpy()
    assert got.shape == (v, -(-v // 16)) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)   # exact indices
    assert stratified_knn.launches == 0


def _near_tie_pair(seed, c=64):
    """x [3, c] (bf16 values): row 0 a query, rows 1 and 2 two candidates
    whose scores differ by 2^-24 exactly (row 2 = row 1 plus 2^-12 in a
    channel where the query is 0), far inside f32 rounding of scores of
    magnitude ~c."""
    x = np.random.default_rng(seed).standard_normal((3, c)).astype(
        np.float32)
    x[0, -1] = 0.0
    x[2] = x[1]
    x[1, -1] = 0.0
    x[2, -1] = 2.0 ** -12
    return torch.from_numpy(x).to(torch.bfloat16).float()


def test_score_bound_accepts_a_near_tie():
    x = _near_tie_pair(0)
    rows, a, b = torch.tensor([0]), torch.tensor([1]), torch.tensor([2])
    xd = x.double()
    gap = abs(float(2 * xd[0] @ xd[1] - xd[1] @ xd[1])
              - float(2 * xd[0] @ xd[2] - xd[2] @ xd[2]))
    assert gap == 2.0 ** -24
    allow = float(score_bound(x, rows, a) + score_bound(x, rows, b))
    assert 0 < gap <= allow
    # a kernel that picked 2 where the plain version picked 1: a near-tie
    got = torch.tensor([[2]], dtype=torch.int32)
    want = torch.tensor([[1]], dtype=torch.int32)
    r = compare_picks(x, got, want)
    assert (r["differ"], r["near_ties"], r["exact_ties"]) == (1, 1, 0)
    assert r["violations"] == [] and 0 < r["worst_gap_over_bound"] <= 1


def test_compare_picks_rejects_the_second_best_pick():
    """Random features: in every stratum the best and the second best are
    far apart against f32 rounding, so the second best as the kernel's
    pick is a violation wherever it differs."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (200, 64)).astype(np.float32))
    want = stratified_knn_torch(x, 16)
    xd = x.to(torch.bfloat16).double()
    score = 2 * xd @ xd.T - (xd * xd).sum(1)[None, :]
    ns = want.shape[1]
    pad = ns * 16 - 200
    score = torch.nn.functional.pad(score, (0, pad), value=float("-inf"))
    second = torch.topk(score.reshape(200, ns, 16), 2, dim=-1).indices[..., 1]
    got = (second + 16 * torch.arange(ns)[None, :]).clamp(max=199).to(
        torch.int32)
    r = compare_picks(x, got, want)
    assert r["differ"] > 0.9 * want.numel()
    assert len(r["violations"]) == r["differ"] - r["exact_ties"] - r[
        "near_ties"]
    assert len(r["violations"]) > 0.9 * want.numel()
    i, s, a, b, gap, allow = r["violations"][0]
    assert gap > allow > 0 and (a, b) == (int(got[i, s]), int(want[i, s]))


def test_compare_picks_identical_columns_tie_exactly():
    """Duplicated vertices: the two picks' scores are equal in double (a
    gap of 0, an exact tie), and equal picks differ nowhere."""
    x = _near_tie_pair(1)
    x[2] = x[1]
    got = torch.tensor([[2]], dtype=torch.int32)
    want = torch.tensor([[1]], dtype=torch.int32)
    r = compare_picks(x, got, want)
    assert (r["differ"], r["exact_ties"], r["near_ties"]) == (1, 1, 0)
    assert r["violations"] == [] and r["worst_gap_over_bound"] == 0.0
    assert compare_picks(x, want, want)["differ"] == 0
    assert float(score_bound(x, torch.tensor([0]), torch.tensor([1]))) > 0


@pytest.mark.parametrize("v,c,want", [
    (7500, 64, 7680 * 4 + 7500 * 64 * 2),    # the GCN's
    (7500, 512, 7680 * 4 + 7500 * 512 * 2),
    (7500, 3, 7680 * 4 + 7500 * 64 * 2),     # rows padded to 64 channels
    (333, 130, 512 * 4 + 333 * 192 * 2),
    (1, 1, 256 * 4 + 64 * 2),
])
def test_knn_work_bytes(v, c, want):
    """The kernel's scratch: |x_j|^2 for every column of its 256-column
    tiles, then x's rows in bf16 padded to a multiple of 64 channels."""
    assert knn_work_bytes(v, c) == want


def test_sample_strata_matches_jax():
    strat = np.arange(7 * 469).reshape(7, 469).astype(np.int32)
    for phase in (0, 1, 5, 18):
        np.testing.assert_array_equal(
            sample_strata(torch.from_numpy(strat), 16, phase).numpy(),
            np.asarray(jax_sample_strata(jnp.asarray(strat), 16, phase,
                                         False, 0.2, None, False)))


def _features(v, c, seed):
    x = np.random.default_rng(seed).standard_normal((v, c)).astype(np.float32)
    return np.maximum(x, 0) if c > 3 else x   # ReLU-like GCN features


@pytest.mark.parametrize("v,c,k", [(512, 3, 16), (700, 64, 32)])
def test_knn_graph_exact_matches_jax(v, c, k):
    x = _features(v, c, 1)
    want = np.asarray(jax_knn_graph(jnp.asarray(x), k, approx=False))
    got = knn_graph(torch.from_numpy(x), k, approx=False).numpy()
    # the same neighbour set per vertex; the order inside it may differ
    # where two f32 distances differ in the last bit (other sum order)
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))


@pytest.mark.parametrize("v,c,k", [(512, 3, 16), (700, 64, 32)])
def test_knn_graph_bf16_matches_jax_up_to_ties(v, c, k):
    """approx=True ranks a bf16 distance matrix.  The port forms it with
    rnr_tpu's roundings, bit for bit.  Exact index equality is not
    attainable: XLA's CPU ApproxTopK fallback sorts unstably, so among
    equal bf16 distances (frequent) its pick is not the lowest index.
    What is checked instead: per vertex, both pick the same multiset of
    distances (a valid top-k of one matrix), and every neighbour strictly
    nearer than the k-th distance is in both sets."""
    x = _features(v, c, 2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    sq = jnp.sum(xb * xb, axis=-1, keepdims=True)
    inner = jax.lax.dot(xb, xb.T, preferred_element_type=jnp.bfloat16)
    jdist = np.asarray((sq + sq.T - 2.0 * inner).astype(jnp.float32))
    tdist = pairwise_distance(torch.from_numpy(x), approx=True).float().numpy()
    np.testing.assert_array_equal(tdist, jdist)

    want = np.asarray(jax_knn_graph(jnp.asarray(x), k, approx=True))
    got = knn_graph(torch.from_numpy(x), k, approx=True).numpy()
    rows = np.arange(v)[:, None]
    np.testing.assert_array_equal(np.sort(tdist[rows, got], 1),
                                  np.sort(jdist[rows, want], 1))
    kth = np.sort(jdist[rows, want], 1)[:, -1:]
    for i in range(v):
        strict = set(want[i][jdist[i, want[i]] < kth[i, 0]])
        assert strict <= set(got[i])
    agree = np.mean([len(set(a) & set(b)) / k for a, b in zip(got, want)])
    assert agree >= 0.95, agree   # measured ~0.987: only boundary ties move


def test_gcn_eval_matches_jax():
    """DenseDeepGCN eval (4 blocks, V=512, stratified from dilation 3; the
    JAX side runs the stratified kernel in interpret mode) with the exact
    graphs: v_feature at f32."""
    v = 512
    pos = np.random.default_rng(5).standard_normal((v, 3)).astype(np.float32)
    kw = dict(n_blocks=4, kernel_size=16, n_filters=16, out_channels=32,
              strat_min_dilation=3, stratum_width=16, knn_approx=False)
    jg = JaxGCN(JaxGCNConfig(num_v=v, **kw))
    variables = jax.device_get(jg.init(jax.random.PRNGKey(0),
                                       jnp.asarray(pos)))
    want = np.asarray(jg.apply(variables, jnp.asarray(pos), train=False,
                               mutable=["spectral"])[0])
    tg = load_jax_variables(DenseDeepGCN(GCNConfig(num_v=v, **kw)),
                            variables)
    with torch.no_grad():
        got = tg(torch.from_numpy(pos)).numpy()
    assert got.shape == (1, 32) and float(np.abs(want).max()) > 1e-3
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
