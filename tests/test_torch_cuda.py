"""CUDA-only tests of the port: the hand-written select kernel against its
plain version, and the kernel tail of ``fused_postprocess`` against the plain
tail, on the card. They skip without a card. This file imports no JAX, so on
a machine without JAX it runs with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import itertools

import pytest
import torch

from yolo_ms_tpu_torch.ops.kernels.select import (
    select,
    select_plain,
    select_scales,
    select_scales_plain,
)
from yolo_ms_tpu_torch.ops.postprocess import fused_postprocess

REG_MAX = 16
NB = 4 * REG_MAX
LTRB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# the serving scales at 640 px, and ragged / misaligned ones: HW 400 is not a
# multiple of the tile, and HW 49 and 25 rows are not 16-byte aligned
SCALE_SETS = {"serving": [80, 40, 20], "ragged": [20, 7, 5]}
LR = 0.01  # the train step's learning rate (its first update's, no warmup)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _views(gen, b, h, w, nc, dtype, layout):
    if layout == "nchw":
        m = torch.randn(b, NB + nc, h, w, generator=gen, device="cuda") * 2.0
        v = m.to(dtype).permute(0, 2, 3, 1).flatten(1, 2)
    else:
        v = (torch.randn(b, h * w, NB + nc, generator=gen, device="cuda") * 2.0).to(dtype)
    if layout == "split":
        return v[..., :NB].contiguous(), v[..., NB:].contiguous()
    return v[..., :NB], v[..., NB:]


def _assert_equal_to_plain(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert (got[2] - want[2]).abs().max().item() <= LTRB_ATOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw_side,nc", [(80, 80), (40, 3), (20, 80), (7, 5)])
def test_kernel_matches_plain(card, hw_side, nc, dtype, layout):
    box, cls = _views(card, 4, hw_side, hw_side, nc, dtype, layout)
    before = select.launches
    got = select(box, cls, REG_MAX)
    assert select.launches == before + 1
    _assert_equal_to_plain(got, select_plain(box, cls, REG_MAX), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", "unsplit", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nc", [80, 3])
@pytest.mark.parametrize("scales", list(SCALE_SETS))
def test_scales_match_plain(card, scales, nc, dtype, layout):
    pairs = [_views(card, 4, s, s, nc, dtype, layout) for s in SCALE_SETS[scales]]
    before = select.launches
    got = select_scales(pairs, REG_MAX)
    assert select.launches == before + 1
    assert got[2].shape == (4, sum(s * s for s in SCALE_SETS[scales]), 4)
    _assert_equal_to_plain(got, select_scales_plain(pairs, REG_MAX), dtype)


@pytest.mark.cuda
def test_copy_routes(card):
    """The NCHW view goes through TMA; aligned channels-last rows through
    16-byte row copies; HW 49 and 134-byte rows element by element."""
    bf16 = torch.bfloat16
    select_scales([_views(card, 2, s, s, 80, bf16, "nchw") for s in (20, 7)], REG_MAX)
    assert select_scales.last_routes == [("tma", "tma"), ("elements", "elements")]
    select_scales([_views(card, 2, 20, 20, 80, bf16, layout) for layout in ("split", "unsplit")],
                  REG_MAX)
    assert select_scales.last_routes == [("rows", "rows")] * 2
    select(*_views(card, 2, 20, 20, 3, bf16, "unsplit"), REG_MAX)
    assert select_scales.last_routes == [("elements", "elements")]


@pytest.mark.cuda
def test_rejects_strides_without_a_unit_one(card):
    box = torch.zeros(2, 64, 2 * NB, device="cuda")[..., ::2]  # strides (8192, 128, 2)
    cls = torch.zeros(2, 64, 80, device="cuda")
    with pytest.raises(ValueError, match="stride of 1"):
        select(box, cls, REG_MAX)


@pytest.mark.cuda
def test_kernel_ties_and_extremes(card):
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.zeros(1, 16, NB + 8, device="cuda", dtype=dtype)
        flat[0, 0, 3] = 100.0
        pairs = [(flat[..., :NB], flat[..., NB:])] * 2
        mx, cid, ltrb = select_scales(pairs, REG_MAX)
        _assert_equal_to_plain((mx, cid, ltrb), select_scales_plain(pairs, REG_MAX), dtype)
        assert int(cid.abs().max()) == 0
        for a in (0, 16):
            assert abs(ltrb[0, a, 0].item() - 3.0) < 1e-4
            assert abs(ltrb[0, a, 1].item() - 7.5) < 1e-4  # trails by 100: clamped flat
        assert torch.isfinite(ltrb).all()


@pytest.mark.cuda
@pytest.mark.parametrize("split", [True, False])
def test_fused_postprocess_kernel_matches_plain(card, split):
    nc = 80
    maps = []
    for h, w in [(16, 16), (8, 8), (4, 4)]:
        box = torch.randn(2, NB, h, w, generator=card, device="cuda") * 1.5
        cls = torch.randn(2, nc, h, w, generator=card, device="cuda") * 1.5
        if split:
            maps.append((box.permute(0, 2, 3, 1), cls.permute(0, 2, 3, 1)))
        else:
            maps.append(torch.cat([box, cls], dim=1).permute(0, 2, 3, 1))
    before = select.launches
    got = fused_postprocess(maps, nc, pre_nms_topk=64, max_det=20)
    assert select.launches == before + 1
    want = fused_postprocess(maps, nc, pre_nms_topk=64, max_det=20, use_kernel=False)
    v = want["valid"]
    assert torch.equal(got["valid"], v)
    assert torch.equal(got["classes"][v], want["classes"][v])
    torch.testing.assert_close(got["scores"][v], want["scores"][v], rtol=1e-5, atol=0)
    torch.testing.assert_close(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-3)


def _train_one_step(device, optimizer):
    """One f32 train step of a seeded yolov8-n (nc=3, 96 px, batch 4) with
    clipping, weight decay and EMA, from the same CPU-drawn weights."""
    import numpy as np

    from yolo_ms_tpu_torch.models.registry import build_model, init_model
    from yolo_ms_tpu_torch.train.loss import DetectionLoss
    from yolo_ms_tpu_torch.train.optim import build_optimizer
    from yolo_ms_tpu_torch.train.trainer import TrainState, make_train_step
    from yolo_ms_tpu_torch.utils.config import TrainingConfig

    model = init_model(build_model("n", num_classes=3, device="cpu"),
                       torch.Generator().manual_seed(0))
    cfg = TrainingConfig(batch_size=4, epochs=1, optimizer=optimizer, learning_rate=LR,
                         weight_decay=5e-4, grad_clip_norm=10.0, ema_decay=0.9999)
    tx, _ = build_optimizer(cfg, 4)
    state = TrainState.create(model.to(device), tx, ema=True)
    state.step.fill_(4000)
    step = make_train_step(DetectionLoss(num_classes=3), tx, cfg.ema_decay, torch.float32)
    rng = np.random.default_rng(0)
    c, wh = rng.uniform(0.35, 0.65, (4, 3, 2)), rng.uniform(0.5, 0.9, (4, 3, 2))
    batch = {
        "images": torch.from_numpy(rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)),
        "boxes": torch.from_numpy(np.concatenate([c, wh], -1).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 3, (4, 3)).astype(np.int32)),
        "mask": torch.ones(4, 3, dtype=torch.bool),
    }
    metrics = step(state, {k: v.to(device) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}, state


# the rounding bound of a gradient (or Adam moment) element: this share of the
# largest |value| of its parameter in the reference, plus rtol of its own
# (two implementations' f32 sums in another order)
ADAM_ROUNDING = 5e-4
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, as the port's


def adam_rounding_bound(x: torch.Tensor, sizes: list[int], rtol: float = 1e-3) -> torch.Tensor:
    """``ADAM_ROUNDING`` times the largest |x| of each element's parameter
    (``sizes``: the numels of the parameters laid end to end in ``x``), plus
    ``rtol`` times |x|."""
    leaf = torch.repeat_interleave(torch.arange(len(sizes)), torch.tensor(sizes))
    top = torch.zeros(len(sizes)).scatter_reduce(0, leaf, x.abs(), "amax")
    return ADAM_ROUNDING * top[leaf] + rtol * x.abs()


def adam_sensitive(mus: list[torch.Tensor], lrs: list[float], sizes: list[int], tol):
    """The elements whose Adam steps could move a parameter by more than
    ``tol`` if each of the reference's gradients moved within its rounding
    bound. The gradients are read back from the reference's first moments
    after each update (``mus``, from the optimizer's start; ``lrs`` their
    learning rates), and Adam is replayed at every corner of the bounds."""
    grads, prev = [], torch.zeros_like(mus[0])
    for mu in mus:
        grads.append((mu - ADAM_B1 * prev) / (1 - ADAM_B1))
        prev = mu
    bounds = [adam_rounding_bound(g, sizes) for g in grads]

    def moved(signs):
        mu = nu = torch.zeros_like(grads[0])
        total = torch.zeros_like(grads[0])
        for n, (g, b, lr, sign) in enumerate(zip(grads, bounds, lrs, signs), start=1):
            g = g + sign * b
            mu = ADAM_B1 * mu + (1 - ADAM_B1) * g
            nu = ADAM_B2 * nu + (1 - ADAM_B2) * g * g
            m_hat, v_hat = mu / (1 - ADAM_B1**n), nu / (1 - ADAM_B2**n)
            total += lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        return total

    base = moved([0] * len(grads))
    worst = torch.zeros_like(base)
    for signs in itertools.product((-1, 1), repeat=len(grads)):
        worst = torch.maximum(worst, (moved(signs) - base).abs())
    return worst > tol


def assert_adam_params_close(got, want, mu_got, mus_want, lrs, sizes, max_step,
                             rtol=1e-3, atol=1e-5) -> int:
    """Adam's update lr * m / (sqrt(v) + eps) is a ratio: where a gradient is
    within rounding of zero, or of eps, the step's sign and size follow the
    order of the sums (lr * sign(g) on the first update, however small g).
    Held, on flat tensors, with the reference's first moments after each
    update (``mus_want``) and the updates' learning rates (``lrs``):
    - every element of the first moment within its rounding bound
      (``adam_rounding_bound``) of the reference's last;
    - every param within rtol / atol, except the elements whose steps, replayed
      from the reference's gradients, could move by more than that within the
      gradients' rounding bounds (``adam_sensitive``);
    - those exempt elements within ``max_step`` (twice the summed learning
      rates).
    Prints and returns the number of exempt elements."""
    mu_want = mus_want[-1]
    d_mu = (mu_got - mu_want).abs()
    off_mu = d_mu > adam_rounding_bound(mu_want, sizes, rtol)
    assert not off_mu.any(), f"{int(off_mu.sum())} first-moment elements beyond rounding"
    # the share of its parameter's largest |moment| that each moment's
    # difference reaches beyond rtol: what ADAM_ROUNDING must cover
    reach = float(((d_mu - rtol * mu_want.abs()).clamp_min(0)
                   / (adam_rounding_bound(mu_want, sizes, 0.0) / ADAM_ROUNDING)
                   .clamp_min(1e-30)).max())
    exempt = adam_sensitive(mus_want, lrs, sizes, atol + rtol * want.abs())
    d = (got - want).abs()
    off = d > atol + rtol * want.abs()
    assert not (off & ~exempt).any(), (
        f"{int((off & ~exempt).sum())} of {off.numel()} params off where the reference's "
        f"steps are not within rounding of moving that far")
    if exempt.any():
        assert d[exempt].max() <= max_step + atol
    print(f"Adam: {int(exempt.sum())} of {got.numel()} elements exempt "
          f"({int((off & exempt).sum())} of them off); moments reach {reach:.2e} of "
          f"their parameter's largest beyond rtol")
    return int(exempt.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_step_on_card_matches_cpu(card, optimizer):
    """The f32 train step (TF32 off) on the card equals the CPU's: loss terms
    rtol 1e-4; params, BN statistics and EMA rtol 1e-3 / atol 1e-5 (for Adam,
    params and EMA params as ``assert_adam_params_close`` says, with the CPU
    as the reference)."""
    card_m, card_state = _train_one_step("cuda", optimizer)
    cpu_m, cpu_state = _train_one_step("cpu", optimizer)
    assert card_m["skipped_nonfinite"] == cpu_m["skipped_nonfinite"] == 0.0
    assert card_m["num_fg"] == cpu_m["num_fg"] > 0
    for k in ("loss_box", "loss_cls", "loss_dfl", "total_loss"):
        assert abs(card_m[k] - cpu_m[k]) <= 1e-4 * abs(cpu_m[k]), k
    for name in ("params", "stats", "ema_params", "ema_stats"):
        got, want = getattr(card_state, name).cpu(), getattr(cpu_state, name)
        if optimizer == "adam" and name.endswith("params"):
            sizes = [p.numel() for p in cpu_state.model.parameters()]
            assert_adam_params_close(got, want, card_state.opt_state["mu"].cpu(),
                                     [cpu_state.opt_state["mu"]], [LR], sizes, 2 * LR)
        else:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
