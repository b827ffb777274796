"""Row parallelism in the port (rnr_tpu's sp axis: image rows across
ranks) on the CPU: ranks are spawned processes joined over Gloo
(`init_distributed`, with its explicit rendezvous timeout), laid out as
rnr_tpu's (dp, sp) mesh.

Two meshes, each one module-scoped fixture: sp 2 (two ranks) and
(dp 2, sp 2) (four ranks), on the global batch of 2 distinct views of
test_torch_parallel.py at its TINY sizes (32^2, num_down 2, nf0 4), f32
U-Net, dropout off, the GCN's picks deterministic and the default border
crop (5), so that the crop at the frame's global edges only is
exercised.  They are held to:
- the port's single-process b2 step (loss terms, psnr_valid and
  mae_valid to 1e-5 relative; each gradient to 1e-4 of its largest
  value, the GCN's, which batch norm blocks, to 1e-6 of the model's
  largest; the gathered image and eval frame to 1e-5 of their largest
  value), RNR and DNR alike;
- rnr_tpu's make_sharded_rnr_train_step on the 8-device CPU mesh at
  make_mesh(2) and make_mesh(4, dp=2) (loss, rtol 1e-4, as
  tests/test_parallel.py:69), and its make_sharded_rnr_eval_step frame
  at make_mesh(2) (1e-4 of the frame's largest value, the single-device
  frame parity of test_torch_slice.py).
Under sp 2 also: every conv route (k3, slab, down4, down4s, convt4,
convt4s, plain) and norm="group", forward and gradients of a
RenderingNet against one process; the halo exchange alone against
slicing the padded whole tensor, its backward against autograd through
that slice; and two negative controls: without the halo the frame's
boundary rows are another function's, and a border crop at each rank's
own edges is another loss.  Last the drivers: train_rnr and test_rnr
with --mesh_devices 2 (sp 2).  The rank-side code lives in this module,
which imports no JAX at its top.
"""

import contextlib
import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rnr_tpu_torch.parallel import (fetch_global, halo_rows, init_distributed,
                                    make_mesh, make_sharded_dnr_train_step,
                                    make_sharded_rnr_eval_step,
                                    make_sharded_rnr_train_step, run_ranks,
                                    shard_rnr_batch)
from rnr_tpu_torch.parallel import sharding
from rnr_tpu_torch.parallel.distributed import free_port
from rnr_tpu_torch.models.unet import RenderingNet
from rnr_tpu_torch.synthetic import init_weights
from rnr_tpu_torch.train.losses import image_l1_loss
from rnr_tpu_torch.train.steps import create_rnr_optimizer, make_generator
from test_torch_parallel import (DNR_CFG, LOSS_KEYS, LR, TINY, TRAIN_ARGS,
                                 _dnr_batch, _dnr_modules, _grad_errors,
                                 _grads, _grads_hold, _losses, _rnr_model,
                                 _scalars, _written, jax_setup,
                                 jax_sharded_loss, single_process)

torch.set_num_threads(2)

MESHES = {"sp2": (2, 1), "dp2sp2": (4, 2)}     # (ranks, dp)
# a route of models/unet.py -> a conv_backend selector that runs it
ROUTES = {"k3": "pallas3", "slab": "slab3", "down4": "pallas",
          "down4s": "p3s4", "convt4": "pallas", "convt4s": "p3s4",
          "plain": "xla"}
PADS = ("reflect", "same")
NET = dict(nf0=16, in_channels=5, out_channels=3, num_down_unet=2,
           use_gcn=False, compute_dtype="float32")
HALO_ROWS = 16                       # the halo case's frame rows


def _net_input() -> tuple[np.ndarray, np.ndarray]:
    """(x [2, 32, 32, 5], the output's cotangent [2, 32, 32, 3])."""
    rng = np.random.default_rng(3)
    return (rng.standard_normal((2, 32, 32, 5)).astype(np.float32),
            rng.standard_normal((2, 32, 32, 3)).astype(np.float32))


def _net(backend: str, pad: str, norm: str) -> RenderingNet:
    return init_weights(RenderingNet(norm=norm, pad_mode=pad,
                                     conv_backend=backend, **NET), 4)


def _net_run(backend: str, pad: str, norm: str, mesh) -> dict:
    """A RenderingNet's output rows, input gradient rows and parameter
    gradients (summed over the ranks) at this rank's rows of
    `_net_input`; mesh None: one process, the whole frame."""
    x, g = (torch.from_numpy(a) for a in _net_input())
    net = _net(backend, pad, norm)
    if mesh is not None:
        rows = sharding.row_sharding(mesh, x.shape[1])
        x, g = x[:, rows], g[:, rows]
    x = x.clone().requires_grad_()
    ctx = (contextlib.nullcontext() if mesh is None else contextlib.ExitStack())
    with ctx as stack:
        if mesh is not None:
            stack.enter_context(sharding.global_batch_norm(net, mesh))
            stack.enter_context(sharding.row_shards(net, mesh))
        y = net(x)
        (y * g).sum().backward()
    if mesh is not None:
        sharding.all_reduce_grads(net, mesh)
    return {"out": y.detach().numpy(), "dx": x.grad.numpy(),
            "grads": _grads(net)}


def _halo_case(mesh) -> dict:
    """halo_rows of this rank's rows of a [2, HALO_ROWS, 5, 3] frame at
    k 1 and 2 under both pads: (the extended rows, the gradient of
    sum(extended * cotangent))."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, HALO_ROWS, 5, 3)
                                             ).astype(np.float32))
    h = HALO_ROWS // mesh.sp
    out = {}
    for pad in PADS:
        for k in (1, 2):
            g = torch.from_numpy(rng.standard_normal((2, h + 2 * k, 5, 3)
                                                     ).astype(np.float32))
            xl = x[:, sharding.row_sharding(mesh, HALO_ROWS)].clone()
            xl.requires_grad_()
            y = halo_rows(xl, mesh, k, pad)
            (y * g).sum().backward()
            out[(pad, k)] = (y.detach().numpy(), xl.grad.numpy(), g.numpy())
    return out


# ------------------------------------------------------------ the ranks


def _rank_case(local_rank: int, port: int, payload_path: str, n: int,
               dp: int) -> dict:
    """One rank of a (dp, n / dp) mesh (rank-side)."""
    torch.set_num_threads(1)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    init_distributed(f"127.0.0.1:{port}", 1, 0, n, local_rank=local_rank,
                     platform="cpu")
    try:
        mesh = make_mesh(n, dp=dp)
        out = {"mesh": (mesh.shape, mesh.world, mesh.rank, mesh.dp_index,
                        mesh.sp_index)}
        batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
        statics = {k: torch.from_numpy(v)
                   for k, v in payload["statics"].items()}
        model = _rnr_model(payload)

        def frame():
            img = make_sharded_rnr_eval_step(model, mesh)(batch)["img"]
            return fetch_global(img, mesh.sp)

        out["frame"] = frame()
        # the control: each rank's convs pad its own rows as a frame
        keep = sharding.row_shards
        sharding.row_shards = functools.partial(keep, halo=False)
        try:
            out["frame_no_halo"] = frame()
        finally:
            sharding.row_shards = keep

        step = make_sharded_rnr_train_step(model,
                                           create_rnr_optimizer(model, LR),
                                           mesh, seed=5)
        met = step(batch, statics, make_generator(0, "cpu"))
        out["metrics"], out["grads"] = _scalars(met), _grads(model)
        out["img"] = fetch_global(met["img"], mesh.sp)
        # the control: the image L1 cropped at each rank's own edges, a
        # local mean over the world size (the dp rule under sp)
        local = shard_rnr_batch(batch, mesh)
        b = model.cfg.loss.border_crop
        out["loss_rn_local_crop"] = float(mesh.sum_(image_l1_loss(
            met["img"], local["img_gt"], local["alpha_map"], b)
            / mesh.world))

        mods = _dnr_modules()
        dnr = make_sharded_dnr_train_step(
            DNR_CFG, mods, create_rnr_optimizer(mods, LR), mesh)
        out["dnr_metrics"] = _scalars(dnr(_dnr_batch(),
                                          make_generator(0, "cpu")))
        out["dnr_grads"] = _grads(mods)

        if mesh.dp == 1:
            out["halo"] = _halo_case(mesh)
            out["nets"] = {(be, pad, norm): _net_run(be, pad, norm, mesh)
                           for be in sorted(set(ROUTES.values()))
                           for pad in PADS for norm in ("batch",)}
            out["nets"].update({("pallas3", pad, "group"): _net_run(
                "pallas3", pad, "group", mesh) for pad in PADS})
        return out
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """rnr_tpu's sharded losses at make_mesh(2) and make_mesh(4, dp=2)
    and its sharded eval frame at make_mesh(2); the port's single-process
    b2 steps and frame; the payload the ranks read."""
    import jax
    from rnr_tpu.parallel import make_mesh as jax_make_mesh
    from rnr_tpu.parallel import make_sharded_rnr_eval_step as jax_eval
    setup = jax_setup()
    jax_loss = {"sp2": jax_sharded_loss(setup, jax_make_mesh(2)),
                "dp2sp2": jax_sharded_loss(setup, jax_make_mesh(4, dp=2))}
    jframe = np.asarray(jax.device_get(jax_eval(
        setup["model"], jax_make_mesh(2))(setup["state"],
                                          setup["batch"])["img"]))
    path = tmp_path_factory.mktemp("sp") / "payload.pkl"
    with open(path, "wb") as f:
        pickle.dump(setup["payload"], f)
    return {"jax_loss": jax_loss, "jax_frame": jframe, "path": str(path),
            "single": single_process(setup["payload"])}


@pytest.fixture(scope="module")
def sp2(reference):
    return run_ranks(_rank_case, 2, free_port(), reference["path"],
                     *MESHES["sp2"])


@pytest.fixture(scope="module")
def dp2sp2(reference):
    return run_ranks(_rank_case, 4, free_port(), reference["path"],
                     *MESHES["dp2sp2"])


@pytest.fixture(params=list(MESHES))
def ranks(request):
    return request.param, request.getfixturevalue(request.param)


# ------------------------------------------------------------ the steps


def test_ranks_lay_out_rnr_tpus_mesh(ranks):
    name, rs = ranks
    n, dp = MESHES[name]
    sp = n // dp
    for r, got in enumerate(rs):
        assert got["mesh"] == ((dp, sp), n, r, r // sp, r % sp)


def test_sp_rnr_step_equals_the_single_process_step(ranks, reference):
    want = reference["single"]
    for got in ranks[1]:
        for k in LOSS_KEYS + ("psnr_valid", "mae_valid"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-5, err_msg=k)
        err = _grad_errors(got["grads"], want["grads"])
        assert _grads_hold(got["grads"], want["grads"]), err
        # fetch_global gathers the rows over sp, the samples over dp
        np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                                   atol=1e-5 * np.abs(want["img"]).max())


def test_gradients_are_bit_equal_across_ranks(ranks):
    r0 = ranks[1][0]
    for got in ranks[1][1:]:
        for k in r0["grads"]:
            np.testing.assert_array_equal(got["grads"][k], r0["grads"][k])


def test_sp_loss_equals_rnr_tpus_sharded_step(ranks, reference):
    name, rs = ranks
    np.testing.assert_allclose(rs[0]["metrics"]["loss"],
                               reference["jax_loss"][name], rtol=1e-4)


def test_sp_eval_frame_equals_the_single_device_frame(ranks, reference):
    want = reference["single"]["frame"]
    for got in ranks[1]:
        np.testing.assert_allclose(got["frame"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_sp_eval_frame_equals_rnr_tpus_sharded_eval(sp2, reference):
    want = reference["jax_frame"]
    assert float(np.std(want)) > 1e-3                  # not a black frame
    np.testing.assert_allclose(sp2[0]["frame"], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_sp_dnr_step_equals_the_single_process_step(ranks, reference):
    want = reference["single"]
    for got in ranks[1]:
        for k in ("loss", "psnr_valid", "mae"):
            np.testing.assert_allclose(got["dnr_metrics"][k],
                                       want["dnr_metrics"][k], rtol=1e-5,
                                       err_msg=k)
        err = _grad_errors(got["dnr_grads"], want["dnr_grads"])
        assert max(err.values()) <= 1e-4, err


# ------------------------------------------------------------ controls


def test_without_the_halo_the_boundary_rows_differ(ranks, reference):
    """Each rank padding its own rows changes the rows at the inner
    edges (rows 15 and 16 of the 32) by far more than the tolerance."""
    want = reference["single"]["frame"]
    got = ranks[1][0]["frame_no_halo"]
    err = np.abs(got - want).max(axis=(0, 2, 3)) / np.abs(want).max()
    assert err[15:17].max() > 1e-2, err


def test_a_border_crop_at_each_ranks_edges_is_another_loss(ranks, reference):
    want = reference["single"]["metrics"]["loss_rn"]
    got = ranks[1][0]["loss_rn_local_crop"]
    assert abs(got - want) > 1e-3 * abs(want), (got, want)


# ------------------------------------------------------------ routes


@functools.lru_cache(maxsize=None)
def _net_single(backend: str, pad: str, norm: str) -> dict:
    return _net_run(backend, pad, norm, None)


def _net_holds(got: list, want: dict) -> None:
    out = np.concatenate([r["out"] for r in got], axis=1)
    dx = np.concatenate([r["dx"] for r in got], axis=1)
    for name, a, b in (("out", out, want["out"]), ("dx", dx, want["dx"])):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
    for r in got:
        err = _grad_errors(r["grads"], want["grads"])
        assert max(err.values()) <= 1e-4, err


@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_every_conv_route_holds_under_sp2(sp2, route, pad):
    """The RenderingNet of the selector that runs `route`, its rows over
    sp 2: the output and input gradient rows and every parameter
    gradient against one process."""
    key = (ROUTES[route], pad, "batch")
    _net_holds([r["nets"][key] for r in sp2], _net_single(*key))


@pytest.mark.parametrize("pad", PADS)
def test_group_norm_holds_under_sp2(sp2, pad):
    key = ("pallas3", pad, "group")
    _net_holds([r["nets"][key] for r in sp2], _net_single(*key))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("pad", PADS)
def test_halo_rows_against_the_padded_frame(sp2, pad, k):
    """Each rank's extended rows equal the whole frame padded by k rows
    (reflected or zero) and sliced; the ranks' gradients equal autograd's
    through those slices."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, HALO_ROWS, 5, 3)
                                             ).astype(np.float32))
    x.requires_grad_()
    mode = "reflect" if pad == "reflect" else "constant"
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 0, k, k),
                                 mode=mode).permute(0, 2, 3, 1)
    h = HALO_ROWS // 2
    total = 0.0
    for s, r in enumerate(sp2):
        y, _, g = r["halo"][(pad, k)]
        part = xp[:, s * h:s * h + h + 2 * k]
        np.testing.assert_array_equal(y, part.detach().numpy())
        total = total + (part * torch.from_numpy(g)).sum()
    total.backward()
    dx = np.concatenate([r["halo"][(pad, k)][1] for r in sp2], axis=1)
    np.testing.assert_allclose(dx, x.grad.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ sp 3, uneven

# a frame of 10 units of 2**num_down = 4 rows over sp 3: 4, 3 and 3 units
# (16, 12, 12 rows); DNR (num_down 3) at 7 units of 8: 24, 16, 16 rows
SP3_ROWS, SP3_DNR_ROWS = 40, 56


def _sp3_batches(payload) -> tuple[dict, dict]:
    """The RNR global batch of 2 distinct views at SP3_ROWS x 32 (the
    synthetic sphere's maps and its mirror image, another target) and a
    DNR batch at SP3_DNR_ROWS x 32."""
    from rnr_tpu_torch.synthetic import build_batch
    b = build_batch(SP3_ROWS, TINY["gcn_v"], batch=2)
    b = {k: (v[:, :, 4:36].copy() if v.ndim >= 3 else v)
         for k, v in b.items()}
    for k, v in b.items():
        if v.ndim >= 3:
            v[1] = np.flip(v[1], axis=1)
    b["img_gt"][1] = 0.8 - 0.5 * b["img_gt"][1]
    rng = np.random.default_rng(7)
    d = {"uv_map": rng.uniform(0, 1, (2, SP3_DNR_ROWS, 32, 2)),
         "sh_basis_map": rng.uniform(-1, 1, (2, SP3_DNR_ROWS, 32, 9)),
         "alpha_map": rng.uniform(size=(2, SP3_DNR_ROWS, 32, 1)) > 0.2,
         "img_gt": rng.uniform(0, 1, (2, SP3_DNR_ROWS, 32, 3))}
    return ({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             b.items()},
            {k: torch.from_numpy(v.astype(np.float32)) for k, v in d.items()})


def _sp3_run(payload, mesh) -> dict:
    """The eval frame, one RNR train step and one DNR step over `mesh`
    (one process when None), at the _sp3_batches."""
    from rnr_tpu_torch.train.steps import (make_dnr_train_step,
                                           make_rnr_eval_step,
                                           make_rnr_train_step)
    batch, dbatch = _sp3_batches(payload)
    statics = {k: torch.from_numpy(v) for k, v in payload["statics"].items()}
    model = _rnr_model(payload)
    out = {}
    img = make_rnr_eval_step(model, mesh=mesh)(batch)["img"]
    out["frame"] = img.numpy() if mesh is None else fetch_global(img, mesh.sp)
    met = make_rnr_train_step(model, create_rnr_optimizer(model, LR),
                              mesh=mesh)(batch, statics,
                                         make_generator(0, "cpu"))
    out["metrics"], out["grads"] = _scalars(met), _grads(model)
    out["img"] = (met["img"].numpy() if mesh is None
                  else fetch_global(met["img"], mesh.sp))
    out["rows"] = met["img"].shape[1]
    mods = _dnr_modules()
    dnr = make_dnr_train_step(DNR_CFG, mods, create_rnr_optimizer(mods, LR),
                              mesh)
    out["dnr_metrics"] = _scalars(dnr(dbatch, make_generator(0, "cpu")))
    out["dnr_grads"] = _grads(mods)
    return out


def _rank_sp3(local_rank: int, port: int, payload_path: str) -> dict:
    """One rank of sp 3 (rank-side)."""
    torch.set_num_threads(1)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    init_distributed(f"127.0.0.1:{port}", 1, 0, 3, local_rank=local_rank,
                     platform="cpu")
    try:
        return _sp3_run(payload, make_mesh(3))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sp3(reference):
    with open(reference["path"], "rb") as f:
        payload = pickle.load(f)
    return {"ranks": run_ranks(_rank_sp3, 3, free_port(), reference["path"]),
            "single": _sp3_run(payload, None)}


def test_sp3_splits_ten_units_as_four_three_three(sp3):
    assert sharding.row_split(SP3_ROWS, 3, 4) == [(16, 0), (12, 16),
                                                   (12, 28)]
    assert [r["rows"] for r in sp3["ranks"]] == [16, 12, 12]
    assert sharding.row_split(SP3_DNR_ROWS, 3, 8) == [(24, 0), (16, 24),
                                                       (16, 40)]


def test_sp3_uneven_rnr_step_equals_the_single_process_step(sp3):
    want = sp3["single"]
    for got in sp3["ranks"]:
        for k in LOSS_KEYS + ("psnr_valid", "mae_valid"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-5, err_msg=k)
        err = _grad_errors(got["grads"], want["grads"])
        assert _grads_hold(got["grads"], want["grads"]), err
        np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                                   atol=1e-5 * np.abs(want["img"]).max())


def test_sp3_uneven_eval_frame_equals_the_single_device_frame(sp3):
    want = sp3["single"]["frame"]
    assert float(np.std(want)) > 1e-3
    for got in sp3["ranks"]:
        np.testing.assert_allclose(got["frame"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_sp3_uneven_dnr_step_equals_the_single_process_step(sp3):
    want = sp3["single"]
    for got in sp3["ranks"]:
        for k in ("loss", "psnr_valid", "mae"):
            np.testing.assert_allclose(got["dnr_metrics"][k],
                                       want["dnr_metrics"][k], rtol=1e-5,
                                       err_msg=k)
        err = _grad_errors(got["dnr_grads"], want["dnr_grads"])
        assert max(err.values()) <= 1e-4, err


# ------------------------------------------------------------ one process


def test_rows_that_do_not_split_raise_before_any_collective():
    """check_rows: a frame's rows in units of 2**num_down, at least 2
    innermost rows a rank; the steps check before their first
    collective (a one-rank mesh dressed as sp 2 has no group); the
    border crop keeps a shard's inner edges."""
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_config
    model = RNRModel(build_config(img_size=32, tex_size=32, lmax=2, nf0=4,
                                  num_down=2, gcn_blocks=2, num_azi=2,
                                  num_polar=1), TINY["gcn_v"], device="cpu")
    mesh = dataclasses.replace(make_mesh(1), sp=2, world=2)
    batch = {"alpha_map": torch.ones(1, 14, 32, 1)}
    with pytest.raises(ValueError, match="num_down"):
        make_sharded_rnr_eval_step(model, mesh)(batch)
    with pytest.raises(ValueError, match="num_down"):
        make_sharded_rnr_train_step(model, create_rnr_optimizer(model, LR),
                                    mesh)(batch, {}, make_generator(0, "cpu"))
    assert sharding.crop_rows(make_mesh(1), 5) == slice(5, -5)
    top, bottom = (dataclasses.replace(mesh, rank=r) for r in (0, 1))
    assert sharding.crop_rows(top, 5) == slice(5, None)
    assert sharding.crop_rows(bottom, 5) == slice(0, -5)
    assert sharding.crop_rows(bottom, 0) == slice(0, None)


# ------------------------------------------------------------ drivers


def test_train_rnr_over_two_row_shards(tmp_path, capfd):
    """train_rnr --mesh_devices 2 (dp 1, sp 2) at 128^2 (train_rnr's 5
    downs leave 2 innermost rows a rank): finite global losses, rank 0's
    files, the gathered validation frames."""
    from rnr_tpu_torch.drivers import train_rnr
    log_dir, model = train_rnr.main(
        TRAIN_ARGS + ["--img_size", "128", "--mesh_devices", "2",
                      "--logging_root", str(tmp_path)])
    assert model is None and _written(tmp_path) == [os.path.basename(log_dir)]
    for f in ("params.json", "summary.json", "model_final.ckpt"):
        assert os.path.isfile(os.path.join(log_dir, f))
    assert len(_written(os.path.join(log_dir, "val_out"))) == 2
    out = capfd.readouterr().out
    assert "mesh (1, 2)" in out
    losses = _losses(out)
    assert len(losses) >= 3 and np.isfinite(losses).all()


def _test_rnr_args(tmp_path) -> list:
    """test_rnr's flags on make_scene's 2-view 32^2 scene and a
    checkpoint of fresh TINY-like weights."""
    from rnr_tpu_torch.config import save_config
    from rnr_tpu_torch.data import load_obj
    from rnr_tpu_torch.drivers import test_rnr
    from rnr_tpu_torch.models.rnr import RNRModel
    from rnr_tpu_torch.synthetic import build_config
    from rnr_tpu_torch.train.checkpoint import save_checkpoint
    from rnr_tpu_torch.train.steps import init_rnr_params
    from rnr_tpu_torch.data.scene import make_scene

    root = make_scene(str(tmp_path / "scene"), num_view=2, hw=32)
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
    return ["--data_root", root, "--checkpoint_dir", ckpt, "--platform",
            "cpu", "--obj_high_fp", "_/mesh.obj", "--obj_gcn_fp",
            "_/mesh.obj", "--img_size", "32", "--sphere_samples_fp",
            "nonexistent.mat"]


def test_test_rnr_over_two_row_shards_renders_the_single_device_frames(
        tmp_path):
    """Each view rendered over sp 2 (the whole G-buffer on each rank, its
    rows through the network, the frame gathered) equals the
    single-device frame; the first sp rank writes the PNGs."""
    from rnr_tpu_torch.drivers import test_rnr
    args = _test_rnr_args(tmp_path)
    one = test_rnr.main(args + ["--out_dir", str(tmp_path / "one")],
                        keep_frames=True)
    two = test_rnr.main(args + ["--out_dir", str(tmp_path / "two"),
                                "--mesh_devices", "2"], keep_frames=True)
    assert one["views"] == two["views"] == 2
    assert one["frames"].keys() == two["frames"].keys()
    for k, f in one["frames"].items():
        f = f.numpy()
        np.testing.assert_allclose(two["frames"][k].numpy(), f, rtol=0,
                                   atol=1e-5 * np.abs(f).max(),
                                   err_msg=str(k))
    assert _written(tmp_path / "two" / "learned0") == _written(
        tmp_path / "one" / "learned0")


def test_test_rnr_per_stage_timing_over_two_row_shards(tmp_path):
    """--per_stage_timing over sp 2 (two Gloo ranks): every bucket of the
    single-device run is timed on the first sp rank (each stage between
    barriers of the sp group, on its rows), and the staged frames,
    gathered, equal the single-device staged frames."""
    from rnr_tpu_torch.drivers import test_rnr
    args = _test_rnr_args(tmp_path) + ["--per_stage_timing", "true"]
    one = test_rnr.main(args + ["--out_dir", str(tmp_path / "one")],
                        keep_frames=True)
    two = test_rnr.main(args + ["--out_dir", str(tmp_path / "two"),
                                "--mesh_devices", "2"], keep_frames=True)
    assert two["views"] == one["views"] == 2
    assert set(two["buckets"]) == set(one["buckets"]) >= {
        "t_raster", "t_preproc", "t_sh", "t_texture", "t_rays", "t_network",
        "t_render"}
    assert all(np.isfinite(v) and v >= 0 for v in two["buckets"].values())
    for k, f in one["frames"].items():
        f = f.numpy()
        np.testing.assert_allclose(two["frames"][k].numpy(), f, rtol=0,
                                   atol=1e-5 * np.abs(f).max(),
                                   err_msg=str(k))

