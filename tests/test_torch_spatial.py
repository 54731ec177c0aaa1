"""The port's hybrid data x spatial (DP x SP) leg on the CPU: the row math,
the height-sharded forward against JAX, the hybrid train step against one
process, and the ``Trainer`` with ``parallel.spatial``.

The ranks run in ``gloo`` child processes (``tests/torch_dp_worker.py``,
at most 4, images of at most 128 px); no JAX train step is compiled here.

- the row math without ranks: for kernels 1-9, strides 1 and 2, heights
  2-20 and 2 or 4 shards, the input rows each shard gathers
  (``conv_rows`` of its output rows), convolved alone with the width
  padded, equal that shard's rows of the full conv (max pools too);
- yolov8-n (nc 8) at 128 px split over 4 ranks through the post-process,
  equal to the port's one process exactly, and against the JAX package's
  ``jit(infer)`` with ``spatial_sharding`` on the virtual mesh at
  ``tests/test_spatial_sharding.py:49-55``'s tolerances, near-equal scores
  compared as sets (the random-init scores cluster at the ``max_det`` cut): at
  128 px the stride-32 map has one row per rank, so SPPF's k=5 pool reads
  rows two ranks away;
- yolo-ms-xs-se (nc 4) at 64 px over 2 ranks, the raw maps against the JAX
  forward (``train=False``) at the parity tolerances: ``SqueezeExcite``'s
  mean and the depthwise k 3-9 of the MS blocks;
- the hybrid train step at (1, 2) and (2, 2), on the JAX spatial test's
  batch and SGD (``tests/test_spatial_sharding.py:79-119``), against the
  port's one process with the JAX test's checks (step 1: ``num_fg`` equal,
  loss rtol 1e-5; step 2: ``num_fg`` within 2, loss rtol 5e-2, parameters
  within 1e-2 in relative norm), the ranks bitwise equal; at (1, 4) at
  32 px, where the deepest levels have fewer rows than ranks (empty
  shards); and yolo-ms-xs-se at (1, 2), the backward of the
  ``SqueezeExcite`` mean and of the depthwise k 3-9 halos;
- ``Trainer.fit`` + ``validate`` with ``parallel.spatial=2`` over 4 ranks
  (the JAX package's ``tests/test_train_e2e.py:136``), its first loss
  against one process;
- the three ``ValueError``s of the ``Trainer`` in one process.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.torch_policy  # noqa: F401 - the port's thread policy
from tests.make_fixtures import make_coco_dataset
from tests.test_torch_models import _random_variables, flax_maps
from tests.torch_dp_worker import finish, lines, spatial_step_setup, start_ranks
from yolo_ms_tpu.models.registry import build_model as jax_build
from yolo_ms_tpu.ops.postprocess import fused_postprocess as jax_fused
from yolo_ms_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolo_ms_tpu.parallel.mesh import replicated_sharding as jax_replicated
from yolo_ms_tpu.parallel.mesh import spatial_sharding as jax_spatial_sharding
from yolo_ms_tpu_torch.infer.program import ServingProgram
from yolo_ms_tpu_torch.models.registry import build_model, init_model
from yolo_ms_tpu_torch.parallel.spatial import conv_rows, row_partition
from yolo_ms_tpu_torch.train.trainer import Trainer
from yolo_ms_tpu_torch.utils.config import Config
from yolo_ms_tpu_torch.utils.convert import variables_to_state_dict

TERMS = ("loss_box", "loss_cls", "loss_dfl", "total_loss")


def _rows(x: torch.Tensor, lo: int, hi: int, fill: float) -> torch.Tensor:
    """Rows [lo, hi) of x (NCHW), rows outside [0, h) filled."""
    h = x.shape[2]
    top, bottom = max(0, -lo), max(0, hi - h)
    inner = x[:, :, max(lo, 0) : min(hi, h)]
    return F.pad(inner, (0, 0, top, bottom), value=fill)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("h", [2, 5, 10, 20])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3, 5, 7, 9])
def test_needed_rows_convolve_to_the_shards_rows(kernel, stride, h, shards):
    p = kernel // 2
    gen = torch.Generator().manual_seed(kernel * 100 + stride * 10 + h)
    x = torch.randn(2, 3, h, 7, generator=gen, dtype=torch.float64)
    w = torch.randn(4, 3, kernel, kernel, generator=gen, dtype=torch.float64)
    full = F.conv2d(x, w, stride=stride, padding=p)
    pools = F.max_pool2d(x, kernel, stride=1, padding=p) if stride == 1 else None
    h_out = full.shape[2]
    parts = row_partition(h_out, shards)
    assert parts[0][0] == 0 and parts[-1][1] == h_out
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    for o0, o1 in parts:
        lo, hi = conv_rows((o0, o1), kernel, stride, p)
        if o1 == o0:
            assert lo == hi
            continue
        got = F.conv2d(_rows(x, lo, hi, 0.0), w, stride=stride, padding=(0, p))
        np.testing.assert_allclose(got.numpy(), full[:, :, o0:o1].numpy(), rtol=1e-12, atol=1e-12)
        if pools is not None:
            got = F.max_pool2d(_rows(x, lo, hi, float("-inf")), kernel, 1, (0, p))
            assert torch.equal(got, pools[:, :, o0:o1])


# ---------------------------------------------------------------- serving


def _serve_ranks(tmp_path, arch, nc, sd, images, world, post):
    torch.save({"arch": arch, "nc": nc, "sd": sd, "images": images, "post": post},
               tmp_path / "spatial_serve.pt")
    return start_ranks("spatial_serve", world, str(tmp_path))


def _rank_results(procs, tmp_path, name, world, timeout=240):
    rcs, outs = finish(procs, timeout)
    assert rcs == [0] * world, "\n".join(o[-3000:] for o in outs)
    return [torch.load(tmp_path / f"{name}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _assert_matches_jax(got: dict, survivors: dict, max_det: int) -> None:
    """The JAX test's checks at its tolerances (valid equal, classes equal,
    scores rtol 1e-5, boxes rtol 1e-4 / atol 1e-3), the order of near-equal
    scores aside: ``survivors`` is JAX's output with every NMS survivor
    listed (``max_det`` = ``pre_nms_topk``), whose first ``max_det`` slots
    are its output at ``max_det``. Slot by slot the valid flags and scores
    agree, and each detection is a distinct JAX survivor of the same class,
    box and score. The random-init scores cluster within 1e-7 of each other
    at the ``max_det`` cut, where ``torch.topk`` and ``approx_max_k`` may
    take different members of a cluster (ROADMAP C, ties)."""
    np.testing.assert_array_equal(got["valid"], survivors["valid"][:, :max_det])
    for b in range(len(got["valid"])):
        v = got["valid"][b]
        np.testing.assert_allclose(got["scores"][b][v], survivors["scores"][b][:max_det][v],
                                   rtol=1e-5)
        pool = [(c, bx, sc) for c, bx, sc, ok in zip(*(survivors[k][b] for k in (
            "classes", "boxes", "scores", "valid"))) if ok]
        for c, bx, sc in zip(got["classes"][b][v], got["boxes"][b][v], got["scores"][b][v]):
            hit = next((i for i, (wc, wb, ws) in enumerate(pool) if wc == c
                        and np.allclose(bx, wb, rtol=1e-4, atol=1e-3)
                        and np.isclose(sc, ws, rtol=1e-5)), None)
            assert hit is not None, f"no JAX detection of class {c}, box {bx}, score {sc}"
            pool.pop(hit)


def test_height_sharded_serving_matches_jax(tmp_path):
    """tests/test_spatial_sharding.py:21 against the port: one 128 px image
    split over 4 ranks."""
    nc, post = 8, dict(conf_thresh=1e-6, pre_nms_topk=64, max_det=16)
    jmodel = jax_build("n", num_classes=nc)
    # init_model's draw, compiled as one program rather than run op by op
    variables = jax.jit(functools.partial(jmodel.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3), jmodel.dtype))
    x = np.random.default_rng(0).standard_normal((1, 128, 128, 3)).astype(np.float32)
    procs = _serve_ranks(tmp_path, "n", nc, variables_to_state_dict(variables), x, 4, post)

    def infer(v, images):
        raw = jmodel.apply(v, images, train=False)
        return jax_fused(raw, nc, **dict(post, max_det=post["pre_nms_topk"]))

    mesh = jax_make_mesh(jax.devices()[:4])
    repl, sp = jax_replicated(mesh), jax_spatial_sharding(mesh)
    want = jax.device_get(jax.jit(infer, in_shardings=(repl, sp), out_shardings=repl)(
        jax.device_put(variables, repl), jax.device_put(jnp.asarray(x), sp)))

    model = build_model("n", num_classes=nc, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    with torch.no_grad():
        one = ServingProgram(model, nc, dtype=torch.float32, **post)(torch.from_numpy(x))

    ranks = _rank_results(procs, tmp_path, "spatial_serve", 4)
    assert want["valid"].any()
    for r, res in enumerate(ranks):
        got = {k: t.numpy() for k, t in res["out"].items()}
        _assert_matches_jax(got, want, post["max_det"])
        for k in got:  # every rank returns the port's one-process detections, exactly
            assert np.array_equal(got[k], one[k].numpy()), (r, k)
        assert res["exchanges"] == ranks[0]["exchanges"] > 0


def test_height_sharded_ms_se_maps_match_jax(tmp_path):
    """yolo-ms-xs-se, 64 px over 2 ranks: the raw maps of the sharded
    forward (the head's gather included) against the JAX forward."""
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build("yolo-ms-xs-se", num_classes=4)
    variables = _random_variables(jmodel, jnp.asarray(x), np.random.default_rng(4))
    procs = _serve_ranks(tmp_path, "yolo-ms-xs-se", 4, variables_to_state_dict(variables), x, 2,
                         dict(conf_thresh=1e-6, pre_nms_topk=64, max_det=16))
    want = flax_maps(jmodel, variables, x)
    ranks = _rank_results(procs, tmp_path, "spatial_serve", 2)
    for res in ranks:
        assert len(res["maps"]) == len(want) == 3
        for g, w in zip(res["maps"], want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-3)
    for a, b in zip(ranks[0]["maps"], ranks[1]["maps"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- training


def _jax_test_batch(img: int, batch: int = 8, nc: int = 4, max_gt: int = 4) -> dict:
    """tests/test_spatial_sharding.py:79-97's batch: distinct random boxes,
    two GT per image. At 32 px the boxes are larger (0.7-0.9 of the image,
    centred), so that the random-init model has TAL positives there too."""
    rng = np.random.default_rng(0)
    lo, hi = ((0.3, 0.7), (0.3, 0.6)) if img >= 64 else ((0.45, 0.55), (0.7, 0.9))
    centers = rng.uniform(*lo, (batch, max_gt, 2)).astype(np.float32)
    sizes = rng.uniform(*hi, (batch, max_gt, 2)).astype(np.float32)
    return {
        "images": rng.standard_normal((batch, img, img, 3)).astype(np.float32),
        "boxes": np.concatenate([centers, sizes], axis=-1),
        "labels": rng.integers(0, nc, (batch, max_gt)).astype(np.int32),
        "mask": np.tile(np.asarray([True, True] + [False] * (max_gt - 2)), (batch, 1)),
    }


# (arch, data, spatial, img); yolo-ms-xs-se holds the backward of the
# SqueezeExcite mean (one all-reduce) and of the MS blocks' k 3-9 halos
MESHES = [("n", 1, 2, 64), ("n", 2, 2, 64), ("n", 1, 4, 32), ("yolo-ms-xs-se", 1, 2, 64)]
MESH_IDS = [f"{d}-{s}-{img}" if arch == "n" else f"{arch}-{d}-{s}-{img}"
            for arch, d, s, img in MESHES]


@pytest.fixture(scope="module")
def hybrid_runs(tmp_path_factory):
    """Every case of MESHES in its own ranks, all started at once, and the
    one-process steps on the same batches meanwhile."""
    nc = 4
    sds = {arch: {k: v.clone() for k, v in init_model(
        build_model(arch, num_classes=nc, device="cpu"),
        torch.Generator().manual_seed(0)).state_dict().items()}
        for arch in dict.fromkeys(m[0] for m in MESHES)}
    started, solo = {}, {}
    for arch, data, spatial, img in MESHES:
        d = tmp_path_factory.mktemp(f"hybrid_{arch}_{data}x{spatial}")
        batch = _jax_test_batch(img)
        torch.save({"sd": sds[arch], "nc": nc, "batch": batch, "steps": 2, "arch": arch},
                   d / "spatial_step.pt")
        started[(arch, data, spatial)] = (d, start_ranks("spatial_step", data * spatial, str(d),
                                                         str(data), str(spatial)))
    for arch, data, spatial, img in MESHES:
        if (arch, img) not in solo:
            state, step = spatial_step_setup(sds[arch], nc, arch=arch)
            host = {k: torch.from_numpy(v) for k, v in _jax_test_batch(img).items()}
            runs = [(None, torch.cat([state.params, state.stats]).clone())]
            for _ in range(2):
                m = step(state, host)
                runs.append(({k: float(v) for k, v in m.items()},
                             torch.cat([state.params, state.stats]).clone()))
            solo[(arch, img)] = runs
    return started, solo


# step 1's parameter update against one process, relative in norm
UPDATE_RTOL = 1e-3


@pytest.mark.parametrize("arch,data,spatial,img", MESHES, ids=MESH_IDS)
def test_hybrid_step_matches_one_process(hybrid_runs, arch, data, spatial, img):
    started, solo = hybrid_runs
    d, procs = started[(arch, data, spatial)]
    world = data * spatial
    ranks = _rank_results(procs, d, f"spatial_step_{data}x{spatial}", world)
    (_, flat0), (m1, flat1), (m2, flat2) = solo[(arch, img)]
    n_params = sum(p.numel() for p in build_model(arch, num_classes=4, device="cpu").parameters())
    for r, res in enumerate(ranks):
        assert res["rows"][0] == 8 // data  # this data row's images, its band of the height
        got1, got2 = res["metrics"]
        assert got1["skipped_nonfinite"] == got2["skipped_nonfinite"] == 0.0
        # step 1 consumes identical params
        assert got1["num_fg"] == m1["num_fg"] > 0, (r, got1, m1)
        for k in TERMS:
            np.testing.assert_allclose(got1[k], m1[k], rtol=1e-5, err_msg=f"rank {r} {k}")
        # step 1's update, the summed gradient through every exchange's
        # backward, against one process's (the JAX rules below compare
        # whole states, within which a wrong halo gradient hides)
        u, w = res["flat"][0][:n_params] - flat0[:n_params], flat1[:n_params] - flat0[:n_params]
        upd = float(torch.linalg.norm(u - w) / torch.linalg.norm(w))
        assert upd < UPDATE_RTOL, (r, upd)
        # step 2: the JAX test's functional-equivalence rules
        assert got2["num_fg"] > 0 and abs(got2["num_fg"] - m2["num_fg"]) <= 2, (got2, m2)
        np.testing.assert_allclose(got2["total_loss"], m2["total_loss"], rtol=5e-2)
        a, b = res["flat"][1][:n_params], flat2[:n_params]
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) < 1e-2
        assert res["exchanges"] > 0
    for res in ranks[1:]:  # every rank commits the same state
        for a, b in zip(res["flat"], ranks[0]["flat"]):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spatial_fit"))
    make_coco_dataset(root, num_images=8, num_classes=2, img_w=96, img_h=96)
    procs = start_ranks("spatial_trainer", 4, root, "sp", "2")
    solo = start_ranks("spatial_trainer", 1, root, "solo", "1")
    rcs, outs = finish(procs)
    solo_rc, solo_out = finish(solo)
    return root, rcs, outs, solo_rc, solo_out


def test_trainer_fit_hybrid_spatial_mesh(trainer_runs):
    root, rcs, outs, solo_rc, solo_out = trainer_runs
    assert rcs == [0] * 4, "\n".join(o[-3000:] for o in outs)
    assert solo_rc == [0], solo_out[0][-3000:]
    want = lines(solo_out[0], "RESULT")[0]
    results = [lines(o, "RESULT")[0] for o in outs]
    for res in results:
        assert res["mesh"] == [2, 2] and res["steps"] == 1
        assert res["val_images_local"]  # the val feed sharded over the data axis
        assert res["exchanges"] > 0
        assert res["map"] is None or np.isfinite(res["map"])
        m, w = res["metrics"][0], want["metrics"][0]
        assert m["num_fg"] == w["num_fg"]
        for k in TERMS:
            np.testing.assert_allclose(m[k], w[k], rtol=1e-4, err_msg=k)
    assert all(r["map"] == results[0]["map"] for r in results)
    states = [torch.load(os.path.join(root, f"sp_rank{r}_final.pt"), weights_only=True)
              for r in range(4)]
    assert states[0]["ema"] is None  # validate served the train model, unsharded
    for st in states[1:]:
        for part in ("model", "opt_state"):
            for k, v in st[part].items():
                assert torch.equal(v, states[0][part][k]), (part, k)
    # only rank 0 writes
    assert os.path.exists(os.path.join(root, "runs_rank0", "sp", "weights", "last.ckpt"))
    assert not any(os.path.exists(os.path.join(root, f"runs_rank{r}")) for r in (1, 2, 3))


@pytest.mark.parametrize("spatial,size,multiscale,match", [
    (3, 64, None, "must divide the image height \\(64\\)"),
    (2, 64, [64, 96, 33], "must divide every multiscale size \\(got 33\\)"),
    (2, 64, [64], "must divide the device count \\(1\\)"),
])
def test_spatial_value_errors(tmp_path, spatial, size, multiscale, match):
    cfg = Config.from_dict({
        "model": {"architecture": "n", "input_size": [size, size]},
        "training": {"log_dir": str(tmp_path), "multiscale_sizes": multiscale},
        "parallel": {"spatial": spatial},
        "device": "cpu",
    })
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, verbose=False)
