"""Checkpoints and configs across the two packages.

- The port reads a checkpoint that rnr_tpu's `save_checkpoint` wrote
  (flax msgpack, decoded by the port's own reader with no msgpack
  package) of a SMALL TrainState, and renders the frame that rnr_tpu's
  model renders from the same state, to the f32 frame tolerance of
  tests/test_torch_slice.py (1e-4 x the frame's largest value).
- The reader against flax's own decoder on the whole state tree, on
  chunked arrays, and against msgpack on every kind of value.
- The port's own format round-trips every tensor and the Adam state;
  `load_checkpoint_parts` restores only the named parts.
- `params.json` written by either package is read by the other.
"""

import dataclasses
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import rnr_tpu.config as jax_config
from rnr_tpu.models.rnr import RNRModel as JaxRNRModel
from rnr_tpu.train import create_rnr_state
from rnr_tpu.train import save_checkpoint as jax_save_checkpoint
import rnr_tpu_torch.config as port_config
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.synthetic import build_batch, init_weights, to_torch
from rnr_tpu_torch.train import checkpoint as ckpt
from rnr_tpu_torch.train.steps import (create_rnr_optimizer, make_generator,
                                       make_rnr_eval_step, make_rnr_train_step)

torch.set_num_threads(2)

SMALL = dict(img_size=32, tex_size=64, lmax=4, num_sample=64, nf0=8,
             num_down=3, gcn_blocks=4, gcn_v=512, num_azi=5, num_polar=1)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A SMALL rnr_tpu TrainState (f32, exact kNN graphs), its SH lighting
    and textures randomised (rnr_tpu starts them black and constant),
    saved by rnr_tpu.train.save_checkpoint."""
    cfg, _, batch = graft._build(rays_dtype="float32", conv_backend="xla",
                                 sh_kernel="xla", **SMALL)
    cfg = dataclasses.replace(
        cfg, gcn=dataclasses.replace(cfg.gcn, knn_approx=False),
        render_net=dataclasses.replace(cfg.render_net,
                                       compute_dtype="float32"))
    jm = JaxRNRModel(cfg=cfg, l_dir=graft._fib_sphere(SMALL["num_sample"]))
    state, _ = create_rnr_state(jm, jax.random.PRNGKey(0), batch, 1e-3)
    rng = np.random.default_rng(0)
    params = dict(state.params)
    params["lighting"] = {"coeff": (0.5 * rng.standard_normal(
        params["lighting"]["coeff"].shape)).astype(np.float32)}
    params["texture_mapper"] = {
        k: (0.5 + 0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in params["texture_mapper"].items()}
    state = state._replace(params=params, step=jnp.asarray(7, jnp.int32))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "model_final.ckpt")
    jax_save_checkpoint(path, state)
    return cfg, jm, state, batch, path


def _port_model(cfg):
    pcfg = port_config.RNRConfig.from_dict(dataclasses.asdict(cfg))
    pcfg = dataclasses.replace(pcfg, render_net=dataclasses.replace(
        pcfg.render_net, conv_backend="pallas3"))
    return RNRModel(pcfg, SMALL["gcn_v"],
                    l_dir=graft._fib_sphere(SMALL["num_sample"]),
                    device="cpu")


def test_reads_rnr_tpu_checkpoint_and_renders_its_frame(jax_checkpoint):
    cfg, jm, state, batch, path = jax_checkpoint
    model = _port_model(cfg)
    assert ckpt.load_checkpoint(path, model) == 7
    variables = {"params": state.params, "constants": state.constants,
                 "spectral": state.spectral}
    jvf = jax.jit(lambda v, p: jm.apply(
        v, p, method=lambda m, p_: m.compute_v_feature(p_)))(
            variables, batch["gcn_pos"])
    jimg = np.asarray(jax.jit(lambda v, b, f: jm.apply(
        v, b, lighting_idx=0, train=False, mutable=["spectral"],
        v_feature_override=f)[0]["img"])(variables, batch, jvf))
    tb = to_torch({k: np.asarray(v) for k, v in batch.items()}, "cpu")
    with torch.inference_mode():
        tvf = model.compute_v_feature(tb["gcn_pos"])
    timg = make_rnr_eval_step(model)(tb, v_feature=tvf)["img"].numpy()
    assert float(np.std(jimg)) > 1e-3          # not a black frame
    scale = float(np.abs(jimg).max())
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-4 * scale)


def test_reader_equals_flax_on_the_whole_state(jax_checkpoint):
    """Every leaf of the decoded state (step, params, constants, spectral,
    the Adam count and moments) equals flax's own msgpack_restore."""
    *_, path = jax_checkpoint
    with open(path, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    got = ckpt.read_flax_state(path)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_ref) == len(flat_got) > 50
    for k, v in flat_ref:
        g = flat_got[k]
        assert np.asarray(g).dtype == np.asarray(v).dtype, k
        assert np.array_equal(np.asarray(g), np.asarray(v)), k
    assert set(got["opt_state"]["0"]) == {"count", "mu", "nu"}


def test_reader_joins_chunked_arrays_and_widens_bfloat16(monkeypatch):
    """flax splits arrays above MAX_CHUNK_SIZE into chunks (shrunk here so
    a small array is chunked); bfloat16 leaves come back as float32."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"big": rng.standard_normal((7, 13)).astype(np.float32),
            "small": np.arange(3, dtype=np.int32),
            "half": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
            "scalar": np.float32(2.5)}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = ckpt._unchunk(ckpt.unpackb(data))
    assert np.array_equal(got["big"], tree["big"])
    assert np.array_equal(got["small"], tree["small"])
    assert np.array_equal(got["half"],
                          np.asarray(tree["half"]).astype(np.float32))
    assert got["scalar"] == np.float32(2.5)


VALUES = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
          2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
          -2 ** 31 - 1, -2 ** 63, 1.5, -0.25, float("inf"), "", "a" * 31,
          "b" * 32, "c" * 300, "d" * 70000, b"", b"x" * 300,
          b"y" * 70000, [], list(range(20)), list(range(70000)), {},
          {str(i): i for i in range(20)}, {"k": [1, {"n": None}]},
          {i: -i for i in range(70000)}]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_reader_matches_msgpack(i):
    """Every msgpack kind: nil, bool, positive and negative fixints, the
    sized ints, float32 / float64, str / bin / array / map of each size
    class; and ext types through fixext and ext 8."""
    data = msgpack.packb(VALUES[i], use_bin_type=True)
    assert ckpt.unpackb(data) == msgpack.unpackb(data, raw=False,
                                                 strict_map_key=False)
    assert ckpt.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


def test_port_checkpoint_round_trips(tmp_path):
    """Every tensor of the state dict and of the Adam state, and the step,
    equal after save and load; no .tmp file left."""
    cfg = graft._build(**SMALL)[0]
    pcfg = port_config.RNRConfig.from_dict(dataclasses.asdict(cfg))
    model = init_weights(RNRModel(pcfg, SMALL["gcn_v"], device="cpu"), 0)
    opt = create_rnr_optimizer(model, 1e-3)
    b = to_torch(build_batch(32, SMALL["gcn_v"]), "cpu")
    from rnr_tpu_torch.synthetic import build_statics
    make_rnr_train_step(model, opt)(b, build_statics(model, 64),
                                    make_generator(0, "cpu"))
    path = str(tmp_path / "m.ckpt")
    ckpt.save_checkpoint(path, model, opt, 11)
    assert not os.path.exists(path + ".tmp")
    other = RNRModel(pcfg, SMALL["gcn_v"], device="cpu")
    opt2 = create_rnr_optimizer(other, 1e-3)
    assert ckpt.load_checkpoint(path, other, opt2) == 11
    for (k, a), (k2, c) in zip(model.state_dict().items(),
                               other.state_dict().items()):
        assert k == k2 and torch.equal(a, c), k
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for k in s1:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[k][name], s2[k][name]), (k, name)


def test_load_checkpoint_parts_restores_only_the_named_parts(tmp_path,
                                                             jax_checkpoint):
    """From either format: the named part's parameters and every buffer
    (SNDense vectors) come from the file, the other parts stay."""
    cfg, _, state, _, jax_path = jax_checkpoint
    src = init_weights(_port_model(cfg), 1)
    port_path = str(tmp_path / "p.ckpt")
    ckpt.save_checkpoint(port_path, src)
    for path, ref in ((port_path, src), (jax_path, None)):
        if ref is None:
            ref = _port_model(cfg)
            ckpt.load_checkpoint(jax_path, ref)
        dst = init_weights(_port_model(cfg), 2)
        before = {k: v.clone() for k, v in dst.state_dict().items()}
        ckpt.load_checkpoint_parts(path, dst, ["render_net"])
        for k, v in dst.state_dict().items():
            from_file = k.startswith("render_net.") or k.endswith(".u")
            want = ref.state_dict()[k] if from_file else before[k]
            assert torch.equal(v, want), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_params_json_read_by_the_other_package(tmp_path, writer):
    """The same JSON from both packages' save_config, and each package's
    load_config of the other's file gives the same config."""
    jcfg, _, _ = graft._build(rays_dtype="bfloat16", conv_backend="pallas3",
                              **SMALL)
    pcfg = port_config.RNRConfig.from_dict(dataclasses.asdict(jcfg))
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jax_config.save_config(jcfg, jpath)
    port_config.save_config(pcfg, ppath)
    assert open(jpath).read() == open(ppath).read()
    if writer == "jax":
        got = port_config.load_config(port_config.RNRConfig, jpath)
        assert got == pcfg
    else:
        got = jax_config.load_config(jax_config.RNRConfig, ppath)
        assert got == jcfg
    # keys of a newer file that a class does not know are ignored
    d = json.load(open(ppath))
    d["train"]["extra"] = 1
    json.dump(d, open(ppath, "w"))
    assert port_config.load_config(port_config.RNRConfig, ppath) == pcfg
