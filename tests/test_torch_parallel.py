"""The port's data-parallel layer on the CPU: ``parallel/distributed.py``,
``parallel/mesh.py``, the global-batch BatchNorm, the loader's shards and
``parallel/dryrun.py``.

Two ``gloo`` ranks run in child processes (``tests/torch_dp_worker.py``,
each with a timeout), after the pattern of the JAX package's
``tests/test_distributed.py``:

- the helpers: ``process_info``, ``is_primary_process``, ``global_max_int``
  (7 and 33 agree on 33), a ``barrier`` that waits for a late rank (twice),
  the differentiable ``all_reduce_sum``, ``leave_group`` (each rank exits
  0, not aborted by a group left to the interpreter's teardown); and their
  one-process no-ops, and the device / backend rules of
  ``maybe_initialize_distributed``;
- BatchNorm: one ``ConvBnSiLU`` with half of a batch on each rank against
  flax's ``apply(train=True, mutable=["batch_stats"])`` on the whole batch
  (outputs and statistics rtol 1e-5 / atol 1e-6, as ``tests/test_syncbn.py``);
  the whole yolov8-n (nc=2, 64 px) against the port's one-process run on the
  global batch, in f64: statistics, input gradients and the rank-summed
  parameter gradients within rtol 1e-9 (the math is the same; in f32 the
  two orders of summation part by up to ~1e-3 of the largest input
  gradient, amplified by BatchNorm over 2x2 maps of a 4-image batch, which
  the train-step tests hold at their loss and state tolerances), and one
  all-reduce per BatchNorm layer in each direction;
- the loader: for train (mosaic, mixup, multiscale) and for the
  ``shard_images_only`` eval feed, with a short final batch, each rank's
  shard is byte-equal to the JAX loader's shard, and the shards in rank
  order are the JAX loader's global batch (numpy only);
- the two-rank dry run.
"""

import flax
import jax
import numpy as np
import pytest
import torch

import tests.torch_policy  # noqa: F401 - the port's thread policy
from tests.make_fixtures import make_coco_dataset
from tests.torch_dp_worker import lines, model_grads, run_ranks
from yolo_ms_tpu.data.coco import CocoDetectionDataset as JaxDataset
from yolo_ms_tpu.data.loader import DetectionLoader as JaxLoader
from yolo_ms_tpu.nn import blocks as jb
from yolo_ms_tpu_torch.data.coco import CocoDetectionDataset
from yolo_ms_tpu_torch.data.loader import DetectionLoader
from yolo_ms_tpu_torch.models.registry import build_model, init_model
from yolo_ms_tpu_torch.nn.blocks import BatchNorm2d, set_batch_norm_group
from yolo_ms_tpu_torch.parallel import distributed as D
from yolo_ms_tpu_torch.parallel.dryrun import dryrun_data_parallel
from yolo_ms_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d, shard_batch
from yolo_ms_tpu_torch.train.loss import DetectionLoss
from yolo_ms_tpu_torch.utils.convert import variables_to_state_dict

SYNCBN_TOL = dict(rtol=1e-5, atol=1e-6)
# the two-rank model against one process in f64: the same math, the sums in
# another order (the ranks take flax's E[x^2] - E[x]^2 variance, one
# process torch's)
MODEL_TOL = dict(rtol=1e-9, atol=1e-10)


def test_two_rank_helpers(tmp_path):
    rcs, outs = run_ranks("helpers", 2, str(tmp_path), timeout=120)
    assert rcs == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    for rank, out in enumerate(outs):
        got = lines(out, "HELPERS")[0]
        assert got["info"]["process_index"] == rank
        assert got["info"]["process_count"] == got["info"]["global_devices"] == 2
        assert got["info"]["backend"] == "gloo" and got["info"]["device"] == "cpu"
        assert got["primary"] == (rank == 0)
        assert got["max"] == 33
        assert got["sum"] == 3.0  # 1 + 2
        assert got["grad"] == 3.0  # the backward sums d(rank's output)/dx over the ranks
        assert got["calls"] == 2  # one collective forward, one backward
        assert got["mesh"]
        assert got["rows"] == ([[0, 1], [2, 3]] if rank == 0 else [[4, 5], [6, 7]])
        assert got["n"] == 3
        assert f"rank {rank} of 2 (gloo, local rank {rank}) on cpu" in out
    assert lines(outs[0], "HELPERS")[0]["waited"] >= 0.5  # rank 0 waited for rank 1


def test_one_process_no_ops(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert D.maybe_initialize_distributed() is False
    assert D.world_size() == 1 and D.get_rank() == 0 and D.is_primary_process()
    assert D.data_parallel_group() is None and make_mesh() is None
    assert D.rank_device() is None
    assert D.global_max_int(5) == 5
    D.barrier("alone", timeout_s=0.01)
    D.leave_group()
    assert D.process_info()["process_count"] == 1
    assert shard_batch({"a": np.arange(4)})["a"].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="need 2 devices for a 1x2 mesh, have 1"):
        make_mesh_2d(1, 2)


def test_backend_rules(monkeypatch):
    """nccl is never swapped for gloo, and a rank never falls back to the
    CPU on its own."""
    with pytest.raises(ValueError, match="nccl"):
        D.maybe_initialize_distributed("nccl", device="cpu", world_size=2, rank=0,
                                       init_method="tcp://localhost:1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            D.maybe_initialize_distributed(world_size=2, rank=0,
                                           init_method="tcp://localhost:1")
    assert not torch.distributed.is_initialized()


def test_conv_bn_global_batch_matches_flax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 12, 8)).astype(np.float32) * 2.0 + 0.5
    fmod = jb.ConvBnSiLU(16, 3)
    variables = flax.core.unfreeze(fmod.init(jax.random.PRNGKey(0), x))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32), variables["batch_stats"])
    want, upd = fmod.apply(variables, x, train=True, mutable=["batch_stats"])
    torch.save({"ctor": (8, 16, 3), "sd": variables_to_state_dict(variables),
                "x": torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()},
               tmp_path / "bn_block.pt")
    rcs, outs = run_ranks("bn_block", 2, str(tmp_path), timeout=120)
    assert rcs == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    got = [torch.load(tmp_path / f"bn_block_rank{r}.pt", weights_only=True) for r in (0, 1)]
    out = torch.cat([g["out"] for g in got]).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(want), **SYNCBN_TOL)
    want_sd = variables_to_state_dict({"batch_stats": jax.device_get(upd["batch_stats"])})
    for key, val in want_sd.items():
        for g in got:
            np.testing.assert_allclose(g["sd"][key].numpy(), val.numpy(), err_msg=key,
                                       **SYNCBN_TOL)
        assert torch.equal(got[0]["sd"][key], got[1]["sd"][key])


def test_model_global_batch_matches_one_process(tmp_path):
    torch.manual_seed(0)
    model = init_model(build_model("n", num_classes=2, device="cpu"),
                       torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    x = (torch.randn(4, 3, 64, 64) * 1.5 + 0.2).double()
    model.double().train()
    with torch.no_grad():
        shapes = [m.shape for m in model(x)]
    model.load_state_dict(sd)  # the statistics as they were
    weights = [torch.randn(s, dtype=torch.float64) for s in shapes]
    torch.save({"sd": sd, "x": x, "w": weights}, tmp_path / "bn_model.pt")
    rcs, outs = run_ranks("bn_model", 2, str(tmp_path), timeout=180)
    assert rcs == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    x_grad, p_grads = model_grads(model, x, weights)  # one process, the global batch
    got = [torch.load(tmp_path / f"bn_model_rank{r}.pt", weights_only=True) for r in (0, 1)]
    np.testing.assert_allclose(torch.cat([g["x_grad"] for g in got]).numpy(), x_grad.numpy(),
                               **MODEL_TOL)
    for g in got:
        assert g["syncs"] == 2 * g["bn_layers"] > 0
        for a, b in zip(g["p_grads"], p_grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **MODEL_TOL)
        for key, val in model.state_dict().items():
            if "running" in key:
                np.testing.assert_allclose(g["sd"][key].numpy(), val.numpy(), err_msg=key,
                                           **MODEL_TOL)
    for key, val in got[0]["sd"].items():
        assert torch.equal(val, got[1]["sd"][key]), key
    for a, b in zip(got[0]["p_grads"], got[1]["p_grads"]):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ loader

AUG = {
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 5.0, "translate": 0.1,
    "scale": 0.5, "shear": 2.0, "fliplr": 0.5, "flipud": 0.2, "mosaic": 1.0, "mixup": 0.5,
}
KEYS = ("images", "boxes", "labels", "mask")


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shard_coco"))
    return make_coco_dataset(root, num_images=10, num_classes=3, img_w=120, img_h=90, seed=4)


def _loaders(coco, shards, **kw):
    images, ann = coco
    args = dict(batch_size=4, img_size=(64, 64), max_gt=8, seed=3, num_workers=2,
                device_normalize=True)
    args.update(kw)
    jds, tds = JaxDataset(images, ann, 3, verbose=False), CocoDetectionDataset(images, ann, 3,
                                                                               verbose=False)
    glob_kw = {k: v for k, v in args.items() if k != "shard_images_only"}
    port = [DetectionLoader(tds, process_shard=(i, shards), **args) for i in range(shards)]
    jax_shards = [JaxLoader(jds, process_shard=(i, shards), **args) for i in range(shards)]
    return port, jax_shards, JaxLoader(jds, **glob_kw)


def _assert_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["train", "train_multiscale", "eval", "eval_images_only"])
def test_loader_shards_are_the_jax_global_batch(coco, kind):
    kw = {
        "train": dict(is_train=True, augmentation=AUG),
        "train_multiscale": dict(is_train=True, augmentation={"fliplr": 0.5, "mosaic": 0.5},
                                 multiscale_sizes=[32, 64, 96], multiscale_interval=1),
        # 10 images in batches of 4: the last batch has 2 rows, all on rank 0
        "eval": dict(is_train=False, drop_last=False),
        "eval_images_only": dict(is_train=False, drop_last=False, shard_images_only=True),
    }[kind]
    port, jax_shards, glob = _loaders(coco, 2, **kw)
    for epoch in (0, 1) if kind.startswith("train") else (0,):
        got = [list(p.epoch(epoch)) for p in port]
        want = [list(j.epoch(epoch)) for j in jax_shards]
        full = list(glob.epoch(epoch))
        assert len(got[0]) == len(got[1]) == len(full) > 0
        for b, g in enumerate(full):
            for r in (0, 1):
                assert got[r][b].keys() == want[r][b].keys()
                for k in KEYS:
                    _assert_equal(got[r][b][k], want[r][b][k])
                assert got[r][b]["num_valid"] == want[r][b]["num_valid"]
            for k in KEYS:
                if kind == "eval_images_only" and k != "images":
                    for r in (0, 1):  # every rank holds the global targets
                        _assert_equal(got[r][b][k], g[k])
                else:
                    _assert_equal(np.concatenate([got[0][b][k], got[1][b][k]]), g[k])
        if kind == "eval":
            assert [(a["num_valid"], b["num_valid"]) for a, b in zip(*got)] == [
                (2, 2), (2, 2), (2, 0)]  # rank 1's last batch is all padding
            assert not got[1][-1]["mask"].any() and not got[1][-1]["images"].any()
        if kind == "eval_images_only":
            assert [b["num_valid"] for b in got[1]] == [4, 4, 2]
            assert got[1][-1]["images"].shape[0] == 2 and not got[1][-1]["images"].any()


def test_batch_norm_group_is_the_callers():
    """BatchNorm takes its group from its own attribute, never from the
    process: None by default (the one-process path, even in a process that
    joined a group), and ``set_batch_norm_group`` sets it on every
    BatchNorm2d of a model and clears it again."""
    model = build_model("n", num_classes=2, device="cpu")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) > 50 and all(m.process_group is None for m in bns)
    group = object()
    assert set_batch_norm_group(model, group) is model
    assert all(m.process_group is group for m in bns)
    assert set_batch_norm_group(model, None) is model
    assert all(m.process_group is None for m in bns)
    assert DetectionLoss(num_classes=2).group is None


def test_two_rank_dryrun(capsys):
    result = dryrun_data_parallel(2, timeout_s=180)
    assert result["num_fg"] > 0 and result["loss_rel_err"] <= 1e-4
    # the hybrid leg: a (1, 2) data x spatial step against the pure DP one
    hybrid = result["hybrid"]
    assert hybrid["mesh"] == [1, 2]
    assert abs(hybrid["total_loss"] - result["total_loss"]) < 1e-3 * max(
        1.0, abs(result["total_loss"]))
    assert "dry run hybrid OK: (1, 2) (data, spatial) mesh" in capsys.readouterr().out
