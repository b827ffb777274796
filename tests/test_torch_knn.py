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
from rnr_tpu_torch.ops.knn_cuda import stratified_knn, stratified_knn_torch

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
