"""Port parity for the tokenizer loop's options: FSQ (``--quantizer fsq``)
against ``vit_tpu.quantize.vq.FSQ`` and an FSQ TiTok's train steps against
the JAX step, the codebook-usage bitmap against JAX's scatter, the
``--watch`` histograms against ``jnp.histogram`` and the JAX logger's
TensorBoard records, and the weight average (``--ema_decay``) against the
JAX ``TrainState``'s, through the checkpointer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import configs, images, jax_params, tiny_preset

from vit_tpu.models.titok import TiTok as JaxTiTok
from vit_tpu.quantize.vq import FSQ as JaxFSQ
from vit_tpu.train.optim import make_optimizer as jax_make_optimizer
from vit_tpu.train.state import TrainState as JaxTrainState
from vit_tpu.train.step import make_tokenizer_train_step as jax_step_factory
from vit_tpu.utils import metrics as jax_metrics
from vit_tpu_torch.bridge import (flatten, flax_from_state_dict,
                                  state_dict_from_flax)
from vit_tpu_torch.models.titok import TiTok
from vit_tpu_torch.quantize.vq import FSQ
from vit_tpu_torch.train.checkpoint import Checkpointer, has_ema, load_params
from vit_tpu_torch.train.optim import make_optimizer
from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.train.step import make_tokenizer_train_step, mark_usage_
from vit_tpu_torch.utils import metrics as port_metrics

# FSQ's quantized values: tanh and the division on both sides in fp32
FSQ_TOL = 1e-6
# A channel whose bounded value lies this close to a half-integer may round
# the other way: torch's and XLA's CPU tanh can differ by an ulp.
NEAR_TIE = 1e-5
# The FSQ TiTok's steps: the BASELINE.md 1e-3 golden contract, as
# tests/test_torch_train.py holds the VQ step.
STEP_TOL = 1e-3
# The average after the optimizer's update: the port rounds e·d and
# p·(1 − d) as written, XLA's CPU backend fuses one product into the sum,
# so the two differ by an fp32 ulp of the result at most.
EMA_REL = 1e-6
OPT = dict(lr=1e-3, warmup_steps=1, train_steps=100, min_lr=1e-4,
           weight_decay=1e-4, clip_norm=1.0)


# -- FSQ ----------------------------------------------------------------------

def _latents(levels, seed: int, n: int = 96):
    return (1.5 * np.random.default_rng(seed).normal(
        size=(n, len(levels)))).astype(np.float32)


def _near_tie_rows(z: np.ndarray, levels) -> np.ndarray:
    half = (np.asarray(levels, np.float64) - 1.0) / 2.0
    bounded = np.tanh(z.astype(np.float64)) * half
    frac = bounded - np.floor(bounded)
    return (np.abs(frac - 0.5) < NEAR_TIE).any(-1)


@pytest.mark.parametrize("levels", [(8, 5, 5, 5), (8,) * 12],
                         ids=["8555", "8x12"])
def test_fsq_matches_jax(levels):
    """Quantized values within ``FSQ_TOL``, the packed indices equal
    (at (8,) * 12 the int32 wrap makes some negative), the straight-through
    gradient equal to ``jax.vjp``'s, a zero loss, codebook_size =
    prod(levels) as a Python int; rows with a channel within ``NEAR_TIE``
    of a rounding tie are left out (none in these seeds)."""
    z = _latents(levels, seed=len(levels))
    g = np.random.default_rng(5).normal(size=z.shape).astype(np.float32)
    jfsq = JaxFSQ(levels=levels)

    def fwd(zz):
        return jfsq.apply({}, zz)

    (q_j, idx_j, loss_j), vjp = jax.vjp(fwd, jnp.asarray(z))
    (dz_j,) = vjp((jnp.asarray(g), np.zeros(idx_j.shape, jax.dtypes.float0),
                   jnp.zeros(())))
    zt = torch.from_numpy(z).requires_grad_(True)
    fsq = FSQ(levels)
    q, idx, loss = fsq(zt)
    (dz,) = torch.autograd.grad(q, zt, torch.from_numpy(g))
    assert fsq.codebook_size == int(np.prod(levels))
    assert type(fsq.codebook_size) is int
    assert idx.dtype == torch.int32 and loss.item() == 0.0
    keep = ~_near_tie_rows(z, levels)
    assert keep.all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(q_j),
                               atol=FSQ_TOL, rtol=0)
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), rtol=FSQ_TOL,
                               atol=FSQ_TOL)
    if len(levels) == 12:
        assert idx.min().item() < 0 < idx.max().item()
    assert float(loss_j) == 0.0


def test_fsq_rejects_wrong_width():
    with pytest.raises(ValueError, match="latent_dim == len"):
        FSQ((8, 8))(torch.zeros(3, 4))


@pytest.mark.parametrize("seed", [0, 1])
def test_usage_bitmap_matches_jax_scatter(seed):
    """``mark_usage_`` against ``usage.at[idx].set(1.0)`` from a bitmap
    that already has codes set: indices in [0, n), in [−n, −1] (from the
    end), below −n and at or above n (dropped), int32 extremes too."""
    n = 32
    rng = np.random.default_rng(seed)
    idx = np.concatenate([
        rng.integers(0, n, 6), rng.integers(-n, 0, 6),
        rng.integers(-5 * n, -n, 4), rng.integers(n, 5 * n, 4),
        [n, -n, -n - 1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    rng.shuffle(idx)
    idx = idx.reshape(5, 5)
    start = (rng.uniform(size=n) < 0.2).astype(np.float32)
    want = jnp.asarray(start).at[jnp.asarray(idx).reshape(-1)].set(1.0)
    got = mark_usage_(torch.from_numpy(start.copy()), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def fsq_setup():
    with tiny_preset():
        cfg_j, cfg_t = configs("float32")
        for cfg in (cfg_j, cfg_t):
            cfg.quantizer = "fsq"
        yield cfg_j, cfg_t, jax_params(cfg_j)


def test_fsq_titok_steps_match_jax(fsq_setup):
    """Three fp32 steps of an FSQ TiTok (default levels (8,) * 12, which
    has no quantizer params: the bridge carries the tree without one)
    against the jitted JAX step from the same weights and batches: the
    codes equal, every metric within ``STEP_TOL``, the usage bitmap equal
    (its wrapped codes mostly dropped), every parameter within
    ``STEP_TOL``."""
    cfg_j, cfg_t, params = fsq_setup
    assert "quant" not in params
    with tiny_preset():
        net_j = JaxTiTok(cfg_j)
        model = TiTok(cfg_t, device="meta")
        model.load_state_dict(state_dict_from_flax(params, cfg_t),
                              assign=True)
    model.train().requires_grad_(True)
    step_j = jax.jit(jax_step_factory(net_j))
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**OPT))
    usage_j = jnp.zeros((cfg_j.codebook_size,))
    state = TrainState.create(model, make_optimizer(**OPT))
    usage = torch.zeros(cfg_t.codebook_size)
    step = make_tokenizer_train_step(model)
    for i in range(3):
        x = images(4, seed=40 + i)
        idx_j = net_j.apply({"params": state_j.params}, jnp.asarray(x),
                            method=net_j.encode)
        with torch.no_grad():
            idx = model.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        state_j, usage_j, m_j, _ = step_j(state_j, jnp.asarray(x), usage_j,
                                          jax.random.PRNGKey(0))
        _, usage, m, _ = step(state, torch.from_numpy(x), usage)
        assert set(m) == set(m_j)
        assert m["train/quant_loss"].item() == 0.0
        for k in m_j:
            np.testing.assert_allclose(m[k].item(), float(m_j[k]),
                                       rtol=STEP_TOL, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(usage.numpy(), np.asarray(usage_j))
    port = flatten(flax_from_state_dict(model.state_dict()))
    ref = flatten(jax.tree.map(np.asarray, state_j.params))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], atol=STEP_TOL, rtol=0,
                                   err_msg=k)


def test_fsq_titok_cannot_decode_indices(fsq_setup):
    _, cfg_t, _ = fsq_setup
    with tiny_preset():
        model = TiTok(cfg_t, device="meta")
    with pytest.raises(NotImplementedError, match="FSQ has no index lookup"):
        model.decode_indices(torch.zeros(1, 8, dtype=torch.int32))


# -- --watch histograms -------------------------------------------------------

def _edge_tensor(seed: int) -> np.ndarray:
    """Seeded values plus every inner edge of their own JAX histogram (the
    edges do not move: min and max stay)."""
    x = np.random.default_rng(seed).normal(size=(40, 25)).astype(np.float32)
    _, edges = jnp.histogram(jnp.asarray(x.reshape(-1)), bins=64)
    return np.concatenate([x.reshape(-1), np.asarray(edges)[1:-1],
                           np.asarray(edges)[1:-1]])


@pytest.mark.parametrize("case", ["titok_params", "inner_edges", "constant"])
def test_tree_histograms_match_jax(case):
    """``tree_histograms`` against ``jax_metrics.tree_histograms`` under
    the same keys: counts equal, edges within one fp32 ulp (equal in these
    cases), each count summing to its tensor's size. ``titok_params``:
    the tiny TiTok's init; ``inner_edges``: values placed on JAX's inner
    edges, which ``torch.histc`` would bin elsewhere; ``constant``: a
    tensor of one value (edges at ± 0.5)."""
    if case == "titok_params":
        with tiny_preset():
            cfg_j, cfg_t = configs("float32")
            tree = jax_params(cfg_j)
            named = state_dict_from_flax(tree, cfg_t)
    else:
        arr = (_edge_tensor(3) if case == "inner_edges"
               else np.full((7, 3), 0.25, np.float32))
        tree = {"blk": {"kernel": arr.reshape(-1, 1)}}
        named = {"blk.weight": torch.from_numpy(arr.reshape(1, -1).copy())}
    want = jax.jit(lambda t: jax_metrics.tree_histograms(t, "grad_hist"))(
        tree)
    got = port_metrics.tree_histograms(named, "grad_hist")
    sizes = {k: v.size for k, v in flatten(tree).items()}
    assert sorted(got) == sorted(want)
    for k, (counts_j, edges_j) in want.items():
        counts, edges = got[k]
        assert counts.dtype == edges.dtype == torch.float32
        np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j),
                                      err_msg=k)
        np.testing.assert_array_max_ulp(edges.numpy(), np.asarray(edges_j),
                                        maxulp=1)
        assert counts.sum().item() == sizes[k.split("/", 1)[1]]


def test_log_histograms_writes_the_jax_tensorboard_records(tmp_path):
    """The same raw-histogram events as the JAX logger's TensorBoard sink
    for the same (counts, edges); nothing without a sink."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    from vit_tpu.utils.logging import MetricsLogger as JaxLogger
    from vit_tpu_torch.utils.logging import MetricsLogger

    x = np.random.default_rng(2).normal(size=300).astype(np.float32)
    counts, edges = jnp.histogram(jnp.asarray(x), bins=64)
    hists = {"grad_hist/enc/proj/kernel": (np.asarray(counts),
                                           np.asarray(edges))}
    runs = {}
    for side, cls in (("jax", JaxLogger), ("port", MetricsLogger)):
        kw = dict(use_wandb=False) if side == "jax" else {}
        log = cls("proj", "run", out_dir=str(tmp_path / side), **kw)
        log.log_histograms(hists, step=4)
        log.close()
        acc = EventAccumulator(str(tmp_path / side / "proj" / "run_tb"))
        acc.Reload()
        runs[side] = acc.Histograms("grad_hist/enc/proj/kernel")
    assert len(runs["port"]) == 1 and runs["port"][0].step == 4
    assert runs["port"][0].histogram_value == runs["jax"][0].histogram_value
    assert runs["port"][0].histogram_value.num == 300
    quiet = MetricsLogger("proj", "quiet", out_dir=str(tmp_path / "q"),
                          tb=False)
    quiet.log_histograms(hists, step=1)
    quiet.close()
    assert [p.name for p in (tmp_path / "q" / "proj").iterdir()] == [
        "quiet.jsonl"]


def test_watch_step_hists_match_jax(fsq_setup):
    """The ``watch=True`` step's ``_hists`` against the JAX step's on the
    same FSQ TiTok and batch: the same keys (a gradient's and a
    parameter's, before the update, per JAX leaf), counts within one of
    JAX's (gradients agree to fp32 noise, not bit for bit), each summing
    to its tensor's size."""
    cfg_j, cfg_t, params = fsq_setup
    with tiny_preset():
        net_j = JaxTiTok(cfg_j)
        model = TiTok(cfg_t, device="meta")
        model.load_state_dict(state_dict_from_flax(params, cfg_t),
                              assign=True)
    model.train().requires_grad_(True)
    state_j = JaxTrainState.create(jax.tree.map(jnp.asarray, params),
                                   jax_make_optimizer(**OPT))
    x = images(4, seed=50)
    _, _, m_j, _ = jax.jit(jax_step_factory(net_j, watch=True))(
        state_j, jnp.asarray(x), jnp.zeros((cfg_j.codebook_size,)),
        jax.random.PRNGKey(0))
    state = TrainState.create(model, make_optimizer(**OPT))
    _, _, m, _ = make_tokenizer_train_step(model, watch=True)(
        state, torch.from_numpy(x), torch.zeros(cfg_t.codebook_size))
    sizes = {k: v.size for k, v in flatten(params).items()}
    assert sorted(m["_hists"]) == sorted(m_j["_hists"])
    assert len(m["_hists"]) == 2 * len(sizes)
    for k, (counts_j, _) in m_j["_hists"].items():
        counts, edges = m["_hists"][k]
        assert counts.shape == (64,) and edges.shape == (65,)
        assert counts.sum().item() == sizes[k.split("/", 1)[1]]
        assert np.abs(counts.numpy() - np.asarray(counts_j)).sum() <= 2, k


# -- EMA ----------------------------------------------------------------------

def _tensors(seed: int, shapes=((8, 6), (6,), (3, 4, 5))):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_ema_update_matches_jax():
    """Three optimizer steps on seeded fp32 tensors with decay 0.9: the
    port's average bit for bit equal to e·d + p·(1 − d) evaluated by JAX
    op by op on the port's parameters, and within ``EMA_REL`` of the
    jitted JAX state's (whose XLA CPU code fuses one product into the
    sum); created as a copy of the parameters, and none without a decay."""
    p0 = _tensors(0)
    names = [f"t{i}" for i in range(len(p0))]
    module = torch.nn.Module()
    for name, p in zip(names, p0):
        module.register_parameter(name, torch.nn.Parameter(
            torch.from_numpy(p.copy())))
    state = TrainState.create(module, make_optimizer(**OPT), ema_decay=0.9)
    assert all(e is not p and torch.equal(e, p)
               for e, p in zip(state.ema_params, state.params))
    assert TrainState.create(module, make_optimizer(**OPT)).ema_params is None
    state_j = JaxTrainState.create({n: jnp.asarray(p) for n, p in
                                    zip(names, p0)},
                                   jax_make_optimizer(**OPT), ema_decay=0.9)
    apply_j = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    for i in range(3):
        g = _tensors(10 + i)
        state_j = jax.block_until_ready(
            apply_j(state_j, dict(zip(names, map(jnp.asarray, g)))))
        before = [e.clone() for e in state.ema_params]
        # copies: the port clips its gradients in place, and jnp.asarray
        # may share the arrays' memory on the CPU
        state.apply_gradients([torch.from_numpy(a.copy()) for a in g])
        for name, e0, e, p in zip(names, before, state.ema_params,
                                  state.params):
            eager = (jnp.asarray(e0.numpy()) * 0.9
                     + jnp.asarray(p.detach().numpy()) * (1 - 0.9))
            np.testing.assert_array_equal(e.numpy(), np.asarray(eager))
            np.testing.assert_allclose(e.numpy(),
                                       np.asarray(state_j.ema_params[name]),
                                       rtol=EMA_REL, atol=1e-7)
    assert state.step.item() == 3


def _tiny_titok_state(seed: int, ema_decay: float, steps: int = 2):
    from vit_tpu_torch.models.titok import TiTokConfig
    from vit_tpu_torch.utils.init import init_params_

    cfg = TiTokConfig(16, 8, 4, 32, 12, "S", dtype=torch.float32)
    for name in ("enc_vit_config", "dec_vit_config"):
        sub = getattr(cfg, name)
        sub.trans_config = sub.trans_config.replace(n_layers=1)
    model = TiTok(cfg)
    init_params_(model, torch.Generator().manual_seed(seed))
    model.train().requires_grad_(True)
    state = TrainState.create(model, make_optimizer(**OPT),
                              ema_decay=ema_decay)
    step = make_tokenizer_train_step(model)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(state, torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3))
                                     .astype(np.float32)), torch.zeros(32))
    return cfg, state


def test_ema_checkpoint_round_trip(tmp_path):
    """An EMA state saved and restored into one of other weights: the
    average bit for bit, apart from the parameters; ``has_ema`` and
    ``load_params(ema=True)`` read it back."""
    cfg, state = _tiny_titok_state(0, 0.9)
    assert not all(torch.equal(e, p) for e, p in
                   zip(state.ema_params, state.params))
    Checkpointer(str(tmp_path)).save(state, config=cfg, tag="best")
    _, other = _tiny_titok_state(1, 0.5, steps=0)
    Checkpointer(str(tmp_path)).restore(other, tag="best")
    for e, e2 in zip(state.ema_params, other.ema_params):
        assert torch.equal(e, e2)
    assert has_ema(str(tmp_path), "best")
    ema = load_params(str(tmp_path), "best", ema=True)
    assert list(ema) == state.names
    assert all(torch.equal(ema[n], e) for n, e in
               zip(state.names, state.ema_params))


def test_resume_pre_ema_checkpoint_into_ema_run(tmp_path):
    """A checkpoint written without EMA restores into an EMA state with the
    average seeded from the restored parameters (as the JAX checkpointer
    re-seeds it), and an EMA checkpoint restores into a state without EMA,
    which drops the average."""
    cfg, plain = _tiny_titok_state(0, 0.0)
    Checkpointer(str(tmp_path / "plain")).save(plain, config=cfg)
    _, ema_state = _tiny_titok_state(1, 0.9)
    Checkpointer(str(tmp_path / "plain")).restore(ema_state)
    for e, p, p0 in zip(ema_state.ema_params, ema_state.params,
                        plain.params):
        assert torch.equal(e, p0) and torch.equal(p, p0) and e is not p
    Checkpointer(str(tmp_path / "ema")).save(ema_state, config=cfg)
    _, no_ema = _tiny_titok_state(2, 0.0, steps=0)
    Checkpointer(str(tmp_path / "ema")).restore(no_ema)
    assert no_ema.ema_params is None
    assert "ema_params" not in no_ema.state_dict()


def test_load_params_ema_needs_an_ema_checkpoint(tmp_path):
    """``load_params(..., ema=True)`` raises on a checkpoint without an
    average, as JAX's does; ``has_ema`` says False; the params still
    load."""
    cfg, state = _tiny_titok_state(0, 0.0, steps=0)
    Checkpointer(str(tmp_path)).save(state, config=cfg, tag="last")
    assert not has_ema(str(tmp_path), "last")
    with pytest.raises(ValueError, match="holds no EMA average"):
        load_params(str(tmp_path), ema=True)
    assert list(load_params(str(tmp_path))) == state.names
    with pytest.raises(FileNotFoundError):
        has_ema(str(tmp_path), "best")
