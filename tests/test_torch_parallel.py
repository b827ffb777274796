"""Data parallelism in the port (rnr_tpu_torch/parallel/) on the CPU:
ranks are spawned processes joined over Gloo (`init_distributed`, with
its explicit rendezvous timeout), the way the drivers start them.

Two ranks run the sharded RNR and DNR training steps and the eval step
at dp = 2 on a global batch of 2 distinct views, small sizes, f32 U-Net,
dropout off and the GCN's picks deterministic (stochastic=False) unless
a test says otherwise, and are held to:
- the port's single-process step on the same global batch (the loss
  terms to 1e-5 relative; each gradient to 1e-4 of its largest value,
  the GCN's, which batch norm blocks (zero in exact arithmetic), to 1e-6
  of the model's largest gradient; the eval frame's rows, at the initial
  weights, to 1e-5 of its largest value);
- rnr_tpu's make_sharded_rnr_train_step on the 8-device CPU mesh at dp =
  2 (loss, rtol 1e-4, as tests/test_parallel.py:69);
- each other: every parameter bit-equal after two steps, dropout on
  (each rank's own masks);
- the same under U-Net remat "wide" and "all", whose recompute repeats
  the cross-rank norms' all-reduces in the backward;
- a negative control: without the cross-rank batch norm the gradients
  are another function's.
The rank-side code lives in this module, which imports no JAX at its
top, so that a spawned rank does not import it.  The drivers run over
ranks too: train_rnr --mesh_devices 2 --mesh_dp 2, two train_rnr
processes joined through --coordinator_address, and test_rnr
--mesh_devices 2 --mesh_dp 2 against a single-device run.
"""

import dataclasses
import hashlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rnr_tpu_torch.config import (DNRConfig, LossConfig, RenderNetConfig,
                                  RNRConfig, TextureConfig)
from rnr_tpu_torch.models.rnr import RNRModel
from rnr_tpu_torch.parallel import (fetch_global, host_local_batch_slice,
                                    init_distributed, is_main_process,
                                    make_mesh, make_sharded_dnr_train_step,
                                    make_sharded_rnr_eval_step,
                                    make_sharded_rnr_train_step, run_ranks,
                                    shard_rnr_batch)
from rnr_tpu_torch.parallel.distributed import free_port
from rnr_tpu_torch.parallel.sharding import (all_reduce_grads, check_rows,
                                             dropout_generator, mesh_shape)
from rnr_tpu_torch.synthetic import build_batch, init_weights
from rnr_tpu_torch.train.steps import (build_dnr_modules,
                                       create_rnr_optimizer, make_generator,
                                       make_dnr_train_step, make_rnr_eval_step,
                                       make_rnr_loss_fn, make_rnr_train_step)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=32, tex_size=32, lmax=2, num_sample=64, nf0=4,
            num_down=2, gcn_blocks=2, gcn_v=256, num_azi=2, num_polar=1)
LR = 1e-3
REMAT_MODES = ("wide", "all")
LOSS_KEYS = ("loss", "loss_rn", "loss_lighting", "loss_rays_lt_chrom",
             "loss_alb")
DNR_CFG = DNRConfig(
    texture=TextureConfig(texture_size=32, texture_num_ch=12, mipmap_level=2),
    render_net=RenderNetConfig(nf0=8, num_down_unet=3),
    loss=LossConfig(border_crop=2))


def _two_views() -> dict:
    """A global batch of 2 distinct views: the synthetic sphere and its
    mirror image with another target."""
    b = build_batch(TINY["img_size"], TINY["gcn_v"], batch=2)
    for k, v in b.items():
        if v.ndim >= 3:
            v[1] = np.flip(v[1], axis=1)
    b["img_gt"][1] = 0.8 - 0.5 * b["img_gt"][1]
    return b


def _dnr_batch() -> dict:
    rng = np.random.default_rng(0)
    b = {"uv_map": rng.uniform(0, 1, (2, 32, 32, 2)),
         "sh_basis_map": rng.uniform(-1, 1, (2, 32, 32, 9)),
         "alpha_map": (rng.uniform(size=(2, 32, 32, 1)) > 0.2),
         "img_gt": rng.uniform(0, 1, (2, 32, 32, 3))}
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in b.items()}


def _dnr_modules():
    mods = init_weights(build_dnr_modules(DNR_CFG, device="cpu"), 1)
    mods.render_net.Unet_0.use_dropout = False
    return mods


def _rnr_model(payload, remat: str = "none") -> RNRModel:
    cfg = dict(payload["cfg"], render_net=dict(payload["cfg"]["render_net"],
                                               remat=remat))
    m = RNRModel(RNRConfig.from_dict(cfg), TINY["gcn_v"],
                 l_dir=payload["l_dir"], device="cpu")
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in payload["state"].items()})
    m.render_net.Unet_0.use_dropout = False
    return m


def _grads(model) -> dict:
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


def _digest(model) -> str:
    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()


def _scalars(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items() if k != "img"}


# ------------------------------------------------------------ the ranks


def _rank_case(local_rank: int, port: int, payload_path: str) -> dict:
    """One rank of the dp = 2 case (rank-side; see the module docstring)."""
    torch.set_num_threads(1)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    init_distributed(f"127.0.0.1:{port}", 1, 0, 2, local_rank=local_rank,
                     platform="cpu")
    try:
        out = {"rank": dist.get_rank(), "main": is_main_process(),
               "slice": host_local_batch_slice(2)}
        mesh = make_mesh(2, dp=2)
        out["mesh"] = (mesh.shape, mesh.world, mesh.rank)
        batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
        statics = {k: torch.from_numpy(v)
                   for k, v in payload["statics"].items()}
        model = _rnr_model(payload)

        # the negative control: the rank's shares and summed gradients,
        # but each rank's batch norm over its own rows
        loss, _ = make_rnr_loss_fn(model, mesh=mesh)(
            shard_rnr_batch(batch, mesh), statics, make_generator(0, "cpu"))
        loss.backward()
        all_reduce_grads(model, mesh)
        out["grads_local_norm"] = _grads(model)

        model.zero_grad(set_to_none=True)
        out["frame"] = make_sharded_rnr_eval_step(model, mesh)(batch)[
            "img"].numpy()
        opt = create_rnr_optimizer(model, LR)
        step = make_sharded_rnr_train_step(model, opt, mesh, seed=5)
        met = step(batch, statics, make_generator(0, "cpu"))
        out["metrics"], out["grads"] = _scalars(met), _grads(model)
        out["img"] = fetch_global(met["img"])
        model.render_net.Unet_0.use_dropout = True
        step(batch, statics, make_generator(1, "cpu"))
        out["digest"] = _digest(model)
        gen = dropout_generator(mesh, 5, "cpu")
        out["mask_draw"] = torch.rand(4, generator=gen).numpy()

        mods = _dnr_modules()
        dnr = make_sharded_dnr_train_step(
            DNR_CFG, mods, create_rnr_optimizer(mods, LR), mesh)
        out["dnr_metrics"] = _scalars(dnr(_dnr_batch(),
                                          make_generator(0, "cpu")))
        out["dnr_grads"] = _grads(mods)

        # remat under dp: the recompute repeats the norms' all-reduces
        for mode in REMAT_MODES:
            model = _rnr_model(payload, mode)
            met = make_sharded_rnr_train_step(
                model, create_rnr_optimizer(model, LR), mesh)(
                    batch, statics, make_generator(0, "cpu"))
            out[f"remat_{mode}"] = _scalars(met), _grads(model)
        return out
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ fixtures


def _no_dropout(next_fun, args, kwargs, context):
    import flax.linen as nn
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def jax_setup() -> dict:
    """rnr_tpu's model, weights, batch (`_two_views`), statics, Adam and
    train state at TINY (f32, xla routes, exact kNN, no stochastic GCN),
    and the port's payload of the same weights (`_rnr_model`)."""
    import jax
    import jax.numpy as jnp
    import optax

    import __graft_entry__ as graft
    from rnr_tpu.models.rnr import RNRModel as JaxRNRModel
    from rnr_tpu.train.steps import TrainState
    from rnr_tpu_torch.convert import load_jax_variables

    jcfg, _, _ = graft._build(rays_dtype="float32", conv_backend="xla",
                              sh_kernel="xla", **TINY)
    jcfg = dataclasses.replace(
        jcfg, gcn=dataclasses.replace(jcfg.gcn, knn_approx=False,
                                      stochastic=False),
        render_net=dataclasses.replace(jcfg.render_net,
                                       compute_dtype="float32"))
    l_dir = graft._fib_sphere(TINY["num_sample"])
    jm = JaxRNRModel(cfg=jcfg, l_dir=l_dir)
    batch = _two_views()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.device_get(jax.jit(lambda r, b: jm.init(
        r, b, lighting_idx=0, train=False))(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1),
             "gcn": jax.random.PRNGKey(2)}, jbatch))
    rng = np.random.default_rng(0)
    params = dict(variables["params"])
    params["lighting"] = {"coeff": (0.5 * rng.standard_normal(
        params["lighting"]["coeff"].shape)).astype(np.float32)}
    tex = {}
    for k, v in params["texture_mapper"].items():
        t = (0.5 + 0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        if k != "texture_0":
            t[..., :6] = 0.0
        tex[k] = t
    params["texture_mapper"] = tex
    variables = dict(variables, params=params)
    statics = {
        "l_samples_init": rng.uniform(0, 1, (TINY["num_sample"], 3)
                                      ).astype(np.float32),
        "l_samples_mask": (rng.uniform(size=TINY["num_sample"]) > 0.3
                           ).astype(np.float32),
        "tex_flatten_init": np.maximum(tex["texture_0"][..., :6], 0.0)}

    tx = optax.adam(LR)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       constants=variables["constants"],
                       spectral=variables["spectral"],
                       opt_state=tx.init(params))
    cfg = dataclasses.asdict(jcfg)
    model = RNRModel(RNRConfig.from_dict(cfg), TINY["gcn_v"], l_dir=l_dir,
                     device="cpu")
    load_jax_variables(model, variables)
    payload = {"cfg": cfg, "l_dir": l_dir, "batch": batch,
               "statics": statics,
               "state": {k: v.numpy().copy()
                         for k, v in model.state_dict().items()}}
    return {"model": jm, "tx": tx, "state": state, "batch": jbatch,
            "statics": statics, "payload": payload}


def jax_sharded_loss(setup: dict, mesh) -> float:
    """The loss of rnr_tpu's make_sharded_rnr_train_step over `mesh`,
    dropout off, on a copy of the state (the step donates its own)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from rnr_tpu.parallel import make_sharded_rnr_train_step as jax_sharded
    sharded = jax_sharded(setup["model"], setup["tx"], mesh)
    state = jax.tree_util.tree_map(jnp.copy, setup["state"])
    with nn.intercept_methods(_no_dropout):
        _, jmet = sharded(state, setup["batch"], setup["statics"],
                          jax.random.PRNGKey(3))
    return float(jmet["loss"])


def single_process(payload: dict) -> dict:
    """The port's single-process b2 RNR step (metrics, gradients, image),
    eval frame at the initial weights and DNR step."""
    batch, statics = payload["batch"], payload["statics"]
    model = _rnr_model(payload)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tstatics = {k: torch.from_numpy(v) for k, v in statics.items()}
    frame = make_rnr_eval_step(model)(tbatch)["img"].numpy()
    met = make_rnr_train_step(model, create_rnr_optimizer(model, LR))(
        tbatch, tstatics, make_generator(0, "cpu"))
    single = {"metrics": _scalars(met), "grads": _grads(model),
              "img": met["img"].numpy(), "frame": frame}
    mods = _dnr_modules()
    dmet = make_dnr_train_step(DNR_CFG, mods, create_rnr_optimizer(mods, LR))(
        _dnr_batch(), make_generator(0, "cpu"))
    single["dnr_metrics"], single["dnr_grads"] = _scalars(dmet), _grads(mods)
    return single


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """rnr_tpu's sharded step's loss at dp = 2, the port's single-process
    step and eval frame at b2, and the two ranks' results."""
    from rnr_tpu.parallel import make_mesh as jax_make_mesh
    setup = jax_setup()
    payload = setup["payload"]
    jax_loss = jax_sharded_loss(setup, jax_make_mesh(2, dp=2))
    single = single_process(payload)

    # the weights go by file: a spawned process reads its arguments only
    # once it has started, so arguments larger than a pipe's buffer would
    # start the ranks one after the other
    path = tmp_path_factory.mktemp("dp") / "payload.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    ranks = run_ranks(_rank_case, 2, free_port(), str(path))
    return {"jax_loss": jax_loss, "single": single, "ranks": ranks}


def _blocked_by_batch_norm(name: str) -> bool:
    return name.startswith("gcn.") or "GcnFuseBlock_0.Dense_0" in name


def _grad_errors(got: dict, want: dict) -> dict:
    """{name: error} against `want`: of each gradient's largest value, or
    of the model's largest for the gradients batch norm blocks."""
    top = max(np.abs(g).max() for g in want.values())
    assert got.keys() == want.keys()
    return {k: float(np.abs(got[k] - want[k]).max()
                     / (top if _blocked_by_batch_norm(k)
                        else max(np.abs(want[k]).max(), 1e-30)))
            for k in want}


def _grads_hold(got: dict, want: dict) -> bool:
    err = _grad_errors(got, want)
    return all(e <= (1e-6 if _blocked_by_batch_norm(k) else 1e-4)
               for k, e in err.items())


# ------------------------------------------------------------ tests


def test_ranks_join_one_group(case):
    r0, r1 = case["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert (r0["main"], r1["main"]) == (True, False)
    assert (r0["slice"], r1["slice"]) == ((1, 0), (1, 1))
    assert r0["mesh"] == ((2, 1), 2, 0) and r1["mesh"] == ((2, 1), 2, 1)


@pytest.mark.parametrize("r", [0, 1])
def test_sharded_rnr_step_equals_the_single_process_step(case, r):
    got, want = case["ranks"][r], case["single"]
    for k in LOSS_KEYS + ("psnr_valid", "mae_valid"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    err = _grad_errors(got["grads"], want["grads"])
    assert _grads_hold(got["grads"], want["grads"]), err
    # fetch_global gathers the ranks' rows of the image in rank order
    np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                               atol=1e-5 * np.abs(want["img"]).max())


def test_sharded_rnr_loss_equals_rnr_tpus_sharded_step(case):
    np.testing.assert_allclose(case["ranks"][0]["metrics"]["loss"],
                               case["jax_loss"], rtol=1e-4)


def test_without_the_cross_rank_norm_the_gradients_differ(case):
    want = case["single"]["grads"]
    for rank in case["ranks"]:
        assert not _grads_hold(rank["grads_local_norm"], want)
        err = _grad_errors(rank["grads_local_norm"], want)
        assert max(e for k, e in err.items()
                   if not _blocked_by_batch_norm(k)) > 1e-2


def test_parameters_stay_bit_equal_across_ranks(case):
    r0, r1 = case["ranks"]
    assert r0["digest"] == r1["digest"]
    for k in r0["grads"]:
        np.testing.assert_array_equal(r0["grads"][k], r1["grads"][k])
    # dropout: each rank its own masks
    assert not np.array_equal(r0["mask_draw"], r1["mask_draw"])


@pytest.mark.parametrize("r", [0, 1])
def test_sharded_eval_rows_equal_the_single_device_frame(case, r):
    want = case["single"]["frame"]
    np.testing.assert_allclose(case["ranks"][r]["frame"][0], want[r],
                               rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("r", [0, 1])
def test_sharded_dnr_step_equals_the_single_process_step(case, r):
    got, want = case["ranks"][r], case["single"]
    for k in ("loss", "psnr_valid", "mae"):
        np.testing.assert_allclose(got["dnr_metrics"][k],
                                   want["dnr_metrics"][k], rtol=1e-5,
                                   err_msg=k)
    err = _grad_errors(got["dnr_grads"], want["dnr_grads"])
    assert max(err.values()) <= 1e-4, err


@pytest.mark.parametrize("mode", REMAT_MODES)
@pytest.mark.parametrize("r", [0, 1])
def test_sharded_rnr_step_under_remat_equals_the_single_process_step(
        case, r, mode):
    (metrics, grads), want = case["ranks"][r][f"remat_{mode}"], case["single"]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(metrics[k], want["metrics"][k], rtol=1e-5,
                                   err_msg=k)
    assert _grads_hold(grads, want["grads"]), _grad_errors(grads,
                                                           want["grads"])


# ------------------------------------------------------------ one process


def test_mesh_shapes_and_what_is_not_ported():
    """Every (dp, sp) factoring is a mesh now (rnr_tpu's layout: dp 1 by
    default, rows over sp = n); what is refused is a factoring that does
    not divide, a mesh without its process group, and rows that do not
    split over sp * 2**num_down."""
    m = make_mesh(1)
    assert (m.shape, m.axis_names, m.world, m.rank) == (
        (1, 1), ("dp", "sp"), 1, 0)
    assert (m.dp_index, m.sp_index) == (0, 0)
    assert mesh_shape(4, 4) == (4, 1)
    assert mesh_shape(8, 2) == (2, 4)
    assert mesh_shape(2) == (1, 2)        # rnr_tpu's dp=1: sp = 2
    with pytest.raises(ValueError, match="factor"):
        make_mesh(3, dp=2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(2)                      # no process group here
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(2, dp=2)
    check_rows(32, 2, 2)
    check_rows(512, 8, 5)
    check_rows(36, 2, 2)                  # 9 units of 4 rows: 5 and 4
    check_rows(480, 2, 5)
    check_rows(480, 4, 5)
    for h, sp in ((34, 2), (32, 8), (8, 2), (12, 2)):
        with pytest.raises(ValueError, match=r"sp \* 2\*\*num_down"):
            check_rows(h, sp, 2)


def test_shard_rnr_batch_slices_the_rows():
    mesh = dataclasses.replace(make_mesh(1), dp=2, world=2, rank=1)
    batch = {k: torch.from_numpy(v) for k, v in build_batch(8, 32, 4).items()}
    batch["scalar"] = torch.ones(4)
    out = shard_rnr_batch(batch, mesh)
    assert torch.equal(out["uv_map"], batch["uv_map"][2:4])
    assert torch.equal(out["gcn_pos"], batch["gcn_pos"])
    assert torch.equal(out["scalar"], batch["scalar"])
    with pytest.raises(ValueError, match="% 2"):
        shard_rnr_batch({"uv_map": batch["uv_map"][:3]}, mesh)


def test_distributed_helpers_on_one_process():
    assert init_distributed(None, None, None) is False
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed("127.0.0.1:1", None, 0)
    assert is_main_process()
    assert host_local_batch_slice(4) == (4, 0)
    x = torch.arange(6.0).to(torch.bfloat16)
    np.testing.assert_array_equal(fetch_global(x), np.arange(6.0))
    assert dropout_generator(make_mesh(1), 0, "cpu") is None


# ------------------------------------------------------------ drivers

TRAIN_ARGS = ["--synthetic", "--platform", "cpu", "--img_size", "32",
              "--texture_size", "32", "--mipmap_level", "2", "--nf0", "4",
              "--n_blocks", "2", "--n_filters", "8", "--kernel_size", "4",
              "--sh_lmax", "2", "--out_channels_gcn", "16",
              "--batch_size", "2", "--max_iter", "3", "--val_freq", "2",
              "--ckp_freq", "100", "--log_freq", "1",
              "--sphere_samples_fp", "nonexistent.mat"]


def _losses(out: str) -> list:
    return [float(line.split(" loss ")[1].split()[0])
            for line in out.splitlines() if line.startswith("Iter ")]


def _written(root) -> list:
    return sorted(os.listdir(root)) if os.path.isdir(root) else []


def test_train_rnr_over_two_spawned_ranks(tmp_path, capfd):
    from rnr_tpu_torch.drivers import train_rnr
    log_dir, model = train_rnr.main(
        TRAIN_ARGS + ["--mesh_devices", "2", "--mesh_dp", "2",
                      "--logging_root", str(tmp_path)])
    assert model is None and os.path.dirname(log_dir) == str(tmp_path)
    assert _written(tmp_path) == [os.path.basename(log_dir)]
    for f in ("params.json", "summary.json", "model_final.ckpt"):
        assert os.path.isfile(os.path.join(log_dir, f))
    assert len(_written(os.path.join(log_dir, "val_out"))) == 2
    # both ranks print each iteration's global loss to one stream, whose
    # lines may interleave; the coordinator test reads them apart
    losses = _losses(capfd.readouterr().out)
    assert len(losses) >= 3 and np.isfinite(losses).all()


def test_train_rnr_over_two_processes_through_a_coordinator(tmp_path):
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rnr_tpu_torch.drivers.train_rnr",
         *TRAIN_ARGS, "--coordinator_address", f"127.0.0.1:{port}",
         "--num_processes", "2", "--process_id", str(pid),
         "--mesh_devices", "2", "--mesh_dp", "2",
         "--logging_root", str(tmp_path / f"logs{pid}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{out[-3000:]}"
    l0, l1 = _losses(outs[0]), _losses(outs[1])
    assert len(l0) == 3 and l0 == l1
    (run,) = _written(tmp_path / "logs0")
    assert os.path.isfile(tmp_path / "logs0" / run / "model_final.ckpt")
    assert _written(tmp_path / "logs1") == []


def test_test_rnr_over_two_ranks_renders_the_single_device_frames(tmp_path):
    """Each view's frame from its rank equals the single-device frame;
    each rank writes its own views' PNGs."""
    from rnr_tpu_torch.config import save_config
    from rnr_tpu_torch.data import load_obj
    from rnr_tpu_torch.drivers import test_rnr
    from rnr_tpu_torch.synthetic import build_config
    from rnr_tpu_torch.train.checkpoint import save_checkpoint
    from rnr_tpu_torch.train.steps import init_rnr_params
    from rnr_tpu_torch.data.scene import make_scene

    root = make_scene(str(tmp_path / "scene"), num_view=4, hw=32)
    cfg = build_config(img_size=32, tex_size=32, lmax=2, nf0=4, num_down=2,
                       gcn_blocks=2, num_azi=2, num_polar=1)
    cfg = dataclasses.replace(cfg, gcn=dataclasses.replace(
        cfg.gcn, kernel_size=4, n_filters=8, out_channels=16))
    nv = len(load_obj(os.path.join(root, "mesh.obj")).v)
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    save_config(cfg, os.path.join(ckpt, "params.json"))
    save_checkpoint(os.path.join(ckpt, "model_final.ckpt"),
                    init_rnr_params(RNRModel(cfg, nv, device="cpu"), 0), None,
                    0)
    args = ["--data_root", root, "--checkpoint_dir", ckpt, "--platform",
            "cpu", "--obj_high_fp", "_/mesh.obj", "--obj_gcn_fp",
            "_/mesh.obj", "--img_size", "32", "--sphere_samples_fp",
            "nonexistent.mat"]
    one = test_rnr.main(args + ["--out_dir", str(tmp_path / "one")],
                        keep_frames=True)
    two = test_rnr.main(args + ["--out_dir", str(tmp_path / "two"),
                                "--mesh_devices", "2", "--mesh_dp", "2"],
                        keep_frames=True)
    assert one["views"] == two["views"] == 4
    assert one["frames"].keys() == two["frames"].keys()
    for k, f in one["frames"].items():
        np.testing.assert_allclose(two["frames"][k].numpy(), f.numpy(),
                                   rtol=0, atol=1e-6, err_msg=str(k))
    assert _written(tmp_path / "two" / "learned0") == _written(
        tmp_path / "one" / "learned0")
    # rows over sp = 8 leave 1 innermost row a rank: refused before any
    # rank starts (the frames over sp are test_torch_sp.py's)
    with pytest.raises(ValueError, match="num_down"):
        test_rnr.main(args + ["--mesh_devices", "8"])
