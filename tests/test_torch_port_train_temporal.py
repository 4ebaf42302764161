"""The temporal train step — one window of frames, G conditioned on its
previous fakes — held to the JAX package's ``loss_and_metrics`` /
``_temporal_losses`` on the CPU, fp32, on the same weights and windows
(numpy seeds):

- a ``temporal_512``-shaped window: the local enhancer (ngf 8, trunk with
  2 downs and 2 blocks, 1 enhancer block), the 2-scale D with feature
  matching and the VGG loss, 64 px, T = 3;
- a ``temporal_256``-shaped window: ResNet-9 (ngf 8), the 2-scale D, L1,
  64 px, T = 3, without its VGG loss (a random VGG at 64 px is too
  kinked to hold ResNet-9's gradients at any bar, see
  ``tests/test_torch_port_train_zoo.py``);
- ``n_frames_g = 3`` (two previous fakes) with dropout and a 2-frame image
  pool over a batch-2, T = 4 window: ResNet-6, 1-scale D.

Each frame's G output on the JAX side is pinned to the port's, as in
``tests/test_torch_port_train.py``, and so is, frame by frame and call by
call, every input of an instance norm (+ activation) and of a plain ReLU
/ LeakyReLU, and every D output; at each ReLU / LeakyReLU after a norm JAX
takes the port's side of the kink (``_JaxKinkPins``, the JAX side of
``chip_smoke.py``'s ``KinkPins``). The pins carry the port's values bit
for bit and JAX's own gradients, so both frameworks take their gradients
at one forward point with one set of kink decisions, each through its
own backward. Why so many: the networks and the L1 terms are piecewise
linear, and at 64 px one unit carries a visible share of a gradient.
Pinned at G's output alone, rounding that differs between the frameworks
flipped a ReLU of the ResNet-9 window (its down conv's gradient moved
0.76%; a 1e-7 change of the inputs moves the port's own window
gradients by up to 1.9%); pinned at the norms' inputs too, one unit
whose normalised value sat within the frameworks' rounding of zero did;
with the norms' decisions pinned, one feature-matching tap where fake
and real differ by 4.5e-8 (adjacent floats) still moved frame 0's
dL/dfake by 0.34%. JAX's own fakes at the pinned point are held to the
port's.
Dropout masks and pool decisions are the ones JAX draws from
its key (``jax.random.split`` as ``_temporal_losses``,
``resnet_generator_apply`` and ``query_pool`` split it), fed to the
port's ``ops.dropout`` and ``image_pool.draw_decisions`` in call order.
Checked: every metric and ``_frame_loss_g`` at rtol 1e-5, every G and D
gradient under ``_mixed_bar`` at 1e-4, the gradient of the last frame's
G loss with respect to every earlier fake (it reaches them only through
the carry: nonzero, and JAX's), the pool after the window, and the
enhancer's and D's gradients with the trunk frozen."""

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import PRESETS as JAX_PRESETS
from ir2rgb_tpu.nn import ops as jops
from ir2rgb_tpu.nn.encoders import instance_edges
from ir2rgb_tpu.train import create_model as jax_create_model
from ir2rgb_tpu.train.image_pool import init_pool as jax_init_pool

from ir2rgb_tpu_torch.checkpoint import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from ir2rgb_tpu_torch.config import PRESETS
from ir2rgb_tpu_torch.nn import ops
from ir2rgb_tpu_torch.train import create_model, image_pool

from test_torch_port_train_zoo import _mixed_bar, _params

SIZE = 64
KEY = 1  # the JAX rng of loss_and_metrics
CASES = {
    "temporal_512": dict(
        preset="temporal_512", t=3, batch=1, n_blocks=2,
        model=dict(ngf=8, ndf=8, n_downsample_global=2, n_blocks_global=2,
                   n_blocks_local=1),
        loss={}),
    "temporal_256": dict(
        preset="temporal_256", t=3, batch=1, n_blocks=9,
        model=dict(ngf=8, ndf=8), loss=dict(no_vgg_loss=True)),
    "g3_dropout_pool": dict(
        preset="temporal_256", t=4, batch=2, n_blocks=6,
        model=dict(ngf=8, ndf=8, net_g="resnet_6blocks", n_frames_g=3,
                   use_dropout=True, net_d="n_layers"),
        loss=dict(no_vgg_loss=True, pool_size=2)),
}


def _cfg(presets, case):
    """The case's config: its preset narrowed by ``model`` / ``loss``,
    ``size`` px (``SIZE`` when not given), no coarse-to-fine freeze.
    ``t`` None: a frame step."""
    cfg = presets[case["preset"]]
    data = dict(crop_size=case.get("size", SIZE), batch_size=case["batch"])
    if case["t"] is not None:
        data["n_frames_total"] = case["t"]
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **case["model"]),
        data=dataclasses.replace(cfg.data, **data),
        loss=dataclasses.replace(cfg.loss, **case["loss"]),
        train=dataclasses.replace(cfg.train, niter_fix_global=0))


def _batch(jcfg, case):
    """numpy inputs (a label model's are class ids, with ids past
    label_nc and halves), targets and, with edges, instance maps of a few
    rectangles; (B, T, H, W, C) for a window."""
    m = jcfg.model
    size = jcfg.data.crop_size
    r = np.random.RandomState(2)
    lead = (case["batch"],) if case["t"] is None else (case["batch"],
                                                         case["t"])
    if m.label_nc > 0:
        a = r.randint(0, 2 * m.label_nc + 4, lead + (size, size, 1)) / 2.0
    else:
        a = r.uniform(-1, 1, lead + (size, size, m.input_nc))
    batch = {"a": a.astype(np.float32),
             "b": r.uniform(-1, 1, lead + (size, size, 3)).astype(np.float32)}
    if m.use_instance_edges:
        inst = np.zeros(lead + (size, size), np.int32)
        for k in range(1, 6):
            y0, x0 = r.randint(0, size - 8, 2)
            inst[..., y0:y0 + r.randint(4, 24), x0:x0 + r.randint(4, 24)] = k
        batch["inst"] = inst
    return batch


def _frame_keys(case, which):
    """JAX's per-frame dropout (``which`` 0) or pool (1) key: the split of
    PRNGKey(KEY) that ``loss_and_metrics`` makes, split again per frame
    in a window (``_temporal_losses``)."""
    k = jax.random.split(jax.random.PRNGKey(KEY))[which]
    return [k] if case["t"] is None else list(jax.random.split(k, case["t"]))


def _drop_keys(jcfg, case):
    """The keys of JAX's dropout masks, in the port's call order: per
    frame the ResNet trunk's blocks (``resnet_generator_apply``) or the
    U-Net's inner middle levels, innermost first
    (``unet_generator_apply``)."""
    m = jcfg.model
    if not m.use_dropout:
        return []
    keys = []
    for kd in _frame_keys(case, 0):
        if m.net_g.startswith("unet"):
            n_drop = (8 if m.net_g == "unet_256" else 7) - 5
            keys += list(jax.random.split(kd, max(n_drop, 1)))[:n_drop]
        else:
            n_blocks = {"resnet_9blocks": 9, "resnet_6blocks": 6}.get(
                m.net_g, m.n_blocks_global)
            keys += list(jax.random.split(kd, n_blocks))
    return keys


def _pool_draws(jcfg, case):
    """JAX's (swap, idx) per query (frame) and batch item, as
    ``query_pool`` draws them from its key."""
    if jcfg.loss.pool_size <= 0:
        return []
    draws = []
    for kp in _frame_keys(case, 1):
        swap, idx = [], []
        for k in jax.random.split(kp, case["batch"]):
            k_swap, k_idx = jax.random.split(k)
            idx.append(int(jax.random.randint(k_idx, (), 0,
                                              jcfg.loss.pool_size)))
            swap.append(bool(jax.random.bernoulli(k_swap)))
        draws.append((swap, idx))
    return draws


def _exact(x, r):
    """``r``'s value, bit for bit, with ``x``'s gradient."""
    return r.astype(x.dtype) + (x - jax.lax.stop_gradient(x))


class _JaxKinkPins:
    """JAX's window held to the port's forward point, frame by frame and
    call by call (``frames[t]`` = the port's records of frame t):

    - every input of ``ops.norm_act``, of ``ops.apply_norm`` (the U-Net's
      norms) and of a ReLU / LeakyReLU ``ops.apply_act`` takes the port's
      value (``norms``: (x, y) of each call), and at a norm's ReLU /
      LeakyReLU JAX takes the port's kink decisions (the sign of its
      output y);
    - every D output (``taps``: the port's netD outputs, each call's
      scales and taps) takes the port's value, so the losses (feature
      matching's |fake - real| among them) decide on the port's floats.

    Values are exact and gradients JAX's own (:func:`_exact`). The pinned
    ``generate`` starts each frame (``start``): a scan traces its body
    once, for every frame, so the frame is a one-hot ``w``."""

    def __init__(self, frames):
        def stack(arrays):
            return jnp.asarray(np.stack(arrays))
        norms = [f["norms"] for f in frames]
        taps = [f["taps"] for f in frames]
        assert len({len(n) for n in norms}) == len({len(t) for t in taps}) == 1
        self.norms = [tuple(stack([n[j][i] for n in norms]) for i in (0, 1))
                      for j in range(len(norms[0]))]
        self.taps = [[[stack([t[j][s][k] for t in taps])
                       for k in range(len(taps[0][j][s]))]
                      for s in range(len(taps[0][j]))]
                     for j in range(len(taps[0]))]
        self.w, self.j, self.dj, self.calls = None, 0, 0, (0, 0)

    def start(self, w):
        self.w, self.j, self.dj = w, 0, 0

    def _frame(self, t):
        return jnp.tensordot(self.w.astype(t.dtype), t, 1)

    def norm_input(self, x):
        """(x at the port's value, the port's output of the call)."""
        r, y = (self._frame(t) for t in self.norms[self.j])
        assert r.shape == x.shape, (self.j, r.shape, x.shape)
        self.j += 1
        self.calls = (max(self.calls[0], self.j), self.calls[1])
        return _exact(x, r), y

    def d_output(self, outs):
        pins = self.taps[self.dj]
        self.dj += 1
        self.calls = (self.calls[0], max(self.calls[1], self.dj))
        return [[_exact(o, self._frame(r)) for o, r in zip(scale, rs)]
                for scale, rs in zip(outs, pins)]

    def read_all(self) -> bool:
        return self.calls == (len(self.norms), len(self.taps))

    @contextlib.contextmanager
    def patched(self):
        norm_act, apply_act = jops.norm_act, jops.apply_act
        apply_norm = jops.apply_norm

        def pinned_norm_act(p, x, norm, act="relu", negative_slope=0.2,
                            **kw):
            x, y = self.norm_input(x)
            if act not in ("relu", "leaky_relu"):
                return norm_act(p, x, norm, act,
                                negative_slope=negative_slope, **kw)
            h = norm_act(p, x, norm, "none", **kw)
            # the port's backward: relu's mask xh > 0, leaky's xh >= 0
            keep = y > 0 if act == "relu" else y >= 0
            low = 0.0 if act == "relu" else negative_slope
            return jnp.where(keep, h, low * h)

        def pinned_apply_norm(p, x, norm, **kw):
            # the U-Net's norms, no activation after
            return apply_norm(p, self.norm_input(x)[0], norm, **kw)

        def pinned_apply_act(x, act, negative_slope=0.2):
            if act in ("relu", "leaky_relu"):
                x = self.norm_input(x)[0]
            return apply_act(x, act, negative_slope)

        jops.norm_act, jops.apply_act = pinned_norm_act, pinned_apply_act
        jops.apply_norm = pinned_apply_norm
        try:
            yield
        finally:
            jops.norm_act, jops.apply_act = norm_act, apply_act
            jops.apply_norm = apply_norm


def _pinned_window(model, a_seq, pins, eps, kinks):
    """The JAX model with frame t's G output pinned to ``pins[t]`` plus
    ``eps[t]`` (zeros, a handle for d loss / d fake_t), and the rest of
    its forward point to ``kinks``. The frame is told apart by its input
    (``a_seq`` the window's inputs; None: a frame step)."""
    pinned = dataclasses.replace(model)

    def generate(g_params, a, prev=None, train=False, rng=None, feat=None,
                 edges=None):
        w = (jnp.ones((1,)) if a_seq is None else
             jnp.stack([jnp.all(a == a_seq[:, t]) for t in
                        range(a_seq.shape[1])]).astype(jnp.float32))
        kinks.start(w)
        out = model.generate(g_params, a, prev, train, rng, feat, edges)
        w = w.astype(out.dtype)
        return (_exact(out, jnp.tensordot(w, pins, 1))
                + jnp.tensordot(w, eps, 1).astype(out.dtype))

    pinned.generate = generate
    pinned.d_apply = lambda p, x: kinks.d_output(model.d_apply(p, x))
    return pinned


def port_step(case, freeze_trunk=False):
    """The port's model with the case's weights (numpy, also for JAX), its
    batch, and its metrics, fakes (one a frame) and carry gradients
    (d(last frame's G loss)/d(earlier fakes)), with the records that pin
    JAX to it; its G and D grads are in ``.grad``. Dropout masks and pool
    decisions are JAX's (``_drop_keys``, ``_pool_draws``)."""
    pcfg, jcfg = _cfg(PRESETS, case), _cfg(JAX_PRESETS, case)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="VGG perceptual loss")
        jm = jax_create_model(jcfg, steps_per_epoch=1)
        pm = create_model(pcfg, device="cpu", steps_per_epoch=1)
    g_params, d_params = _params(jm.g_init, 0), _params(jm.d_init, 1)
    pm.netG.load_state_dict(generator_state_dict_from_jax(g_params,
                                                          pm.gen_cfg))
    pm.netD.load_state_dict(discriminator_state_dict_from_jax(d_params,
                                                              pm.disc_cfg))
    if pm.vgg is not None:
        pm.vgg.load_state_dict(vgg_state_dict_from_jax(
            jax.tree.map(np.asarray, jm.vgg_params)))
    batch = _batch(jcfg, case)
    queue_k, queue_d = _drop_keys(jcfg, case), _pool_draws(jcfg, case)

    def dropout(x, rate, generator):
        mask = np.asarray(jax.random.bernoulli(queue_k.pop(0), 1.0 - rate,
                                               tuple(x.shape)))
        return torch.where(torch.from_numpy(mask), x / (1.0 - rate),
                           0.0).to(x.dtype)

    def draw(n, pool_size, generator):
        swap, idx = queue_d.pop(0)
        return torch.tensor(swap), torch.tensor(idx)

    # per frame: the input and output of every norm (+ act) and of every
    # plain ReLU / LeakyReLU, and every D output
    kinks = []
    saved_norm, saved_act = ops.fused_instance_norm_act, ops.apply_act

    def numpy(t):
        return t.detach().numpy().copy()

    def norm(x, act="relu", negative_slope=0.2):
        y = saved_norm(x, act, negative_slope)
        kinks[-1]["norms"].append((numpy(x), numpy(y)))
        return y

    def apply_act(x, act, negative_slope=0.2):
        y = saved_act(x, act, negative_slope)
        if act in ("relu", "leaky_relu"):
            kinks[-1]["norms"].append((numpy(x), numpy(y)))
        return y

    fakes = []
    hooks = (pm.netG.register_forward_pre_hook(
                 lambda mod, args: kinks.append(dict(norms=[], taps=[]))),
             pm.netG.register_forward_hook(
                 lambda mod, args, out: fakes.append(out)),
             pm.netD.register_forward_hook(
                 lambda mod, args, out: kinks[-1]["taps"].append(
                     [[numpy(t) for t in scale] for scale in out])))
    saved = (ops.dropout, image_pool.draw_decisions,
             ops.fused_instance_norm_act, ops.apply_act)
    (ops.dropout, image_pool.draw_decisions, ops.fused_instance_norm_act,
     ops.apply_act) = dropout, draw, norm, apply_act
    try:
        loss_g, loss_d, metrics = pm.loss_and_metrics(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            freeze_trunk=freeze_trunk)
    finally:
        (ops.dropout, image_pool.draw_decisions, ops.fused_instance_norm_act,
         ops.apply_act) = saved
        for h in hooks:
            h.remove()
    assert not queue_k and not queue_d  # every draw was used, in order
    carry = (torch.autograd.grad(metrics["_frame_loss_g"][-1], fakes[:-1],
                                 retain_graph=True) if len(fakes) > 1 else ())
    (loss_g + loss_d).backward()
    return dict(jm=jm, pm=pm, g_params=g_params, d_params=d_params,
                batch=batch, metrics=metrics, carry=carry, kinks=kinks,
                fakes=[f.detach().numpy() for f in fakes])


def jax_step(port):
    """JAX's pinned step at the port's forward point: (G grads, D grads),
    metrics, d(last frame's G loss)/d(fake_t), the pool after, and JAX's
    own fakes (at the port's carries)."""
    jm, batch = port["jm"], port["batch"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    window = jm.cfg.model.model == "temporal"
    pins = jnp.asarray(np.stack(port["fakes"]))
    eps0 = jnp.zeros_like(pins)
    cfg = jm.cfg
    size = cfg.data.crop_size
    pool = jax_init_pool(cfg.loss.pool_size, (size, size, 3))
    key = jax.random.PRNGKey(KEY)
    kinks = _JaxKinkPins(port["kinks"])

    @jax.jit
    def run(params, eps):
        def total(params, eps):
            t, (metrics, pool_out) = _pinned_window(
                jm, jbatch["a"] if window else None, pins, eps,
                kinks).loss_and_metrics(
                    params[0], params[1], jbatch, key, pool)
            return t, (metrics, pool_out)
        grads, (metrics, pool_out) = jax.grad(total, has_aux=True)(params,
                                                                   eps)
        carry = (jax.grad(lambda e: total(params, e)[1][0][
            "_frame_loss_g"][-1])(eps) if window else None)
        return grads, metrics, carry, pool_out

    with kinks.patched():
        grads, metrics, carry, pool_out = run(
            (port["g_params"], port["d_params"]), eps0)
    # every pin was read, in the port's order
    assert kinks.read_all()
    # JAX's own G at the port's carries (the same dropout keys)
    n_prev = cfg.model.n_frames_g - 1
    drop_keys = _frame_keys(dict(t=batch["a"].shape[1] if window else None),
                            0)

    @jax.jit
    def own(g_params):
        if not window:
            edges = (instance_edges(jbatch["inst"])
                     if cfg.model.use_instance_edges else None)
            return [jm.generate(g_params, jbatch["a"], train=True,
                                rng=drop_keys[0], edges=edges)]
        out, prev = [], jnp.zeros(batch["a"].shape[:1]
                                  + (size, size, 3 * n_prev))
        for t in range(batch["a"].shape[1]):
            out.append(jm.generate(g_params, jbatch["a"][:, t], prev=prev,
                                   train=True, rng=drop_keys[t]))
            prev = jnp.concatenate([pins[t], prev], -1)[..., :3 * n_prev]
        return out

    return dict(grads=grads, metrics=metrics, carry=carry, pool=pool_out,
                own=[np.asarray(f) for f in own(port["g_params"])])


@pytest.fixture(scope="module", autouse=True)
def _first_torch_tanh():
    """PyTorch's CPU tanh can be off by ~5e-5 on its first call in a
    process (``tests/test_torch_port_kernels.py`` says when); make that
    call here, before any fake is compared."""
    torch.tanh(torch.zeros(8))


def cached_steps(cases):
    """name -> (name, port side, JAX side) of ``cases[name]``, each
    computed on first use."""
    done = {}

    def get(name):
        if name not in done:
            port = port_step(cases[name])
            done[name] = (name, port, jax_step(port))
        return done[name]
    return get


@pytest.fixture(scope="module")
def windows():
    return cached_steps(CASES)


@pytest.fixture(params=sorted(CASES))
def window(request, windows):
    return windows(request.param)


def state_dicts(pm, grads):
    g, d = grads
    return (generator_state_dict_from_jax(jax.tree.map(np.asarray, g),
                                          pm.gen_cfg),
            discriminator_state_dict_from_jax(jax.tree.map(np.asarray, d),
                                              pm.disc_cfg))


def test_window_metrics_match_jax(window):
    name, port, jax_side = window
    # the pin moves JAX's fakes by fp32 rounding only
    for got, want in zip(port["fakes"], jax_side["own"]):
        np.testing.assert_allclose(got, want, atol=1e-5)
    want = {k: np.asarray(v) for k, v in jax_side["metrics"].items()}
    got = {k: v.detach().numpy() for k, v in port["metrics"].items()}
    assert set(got) == set(want)
    assert want["_frame_loss_g"].shape == (CASES[name]["t"],)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_window_every_gradient_matches_jax(window):
    _, port, jax_side = window
    pm = port["pm"]
    want_g, want_d = state_dicts(pm, jax_side["grads"])
    got_g = {k: p.grad for k, p in pm.netG.named_parameters()}
    got_d = {k: p.grad for k, p in pm.netD.named_parameters()}
    assert all(v is not None for v in (*got_g.values(), *got_d.values()))
    assert set(got_g) <= set(want_g) and set(got_d) <= set(want_d)
    assert _mixed_bar(got_g, {k: want_g[k] for k in got_g}, 1e-4) == {}
    assert _mixed_bar(got_d, {k: want_d[k] for k in got_d}, 1e-4) == {}


def test_window_gradient_through_the_carry_matches_jax(window):
    # d(last frame's G loss)/d(fake_s), s earlier: only the carry links
    # them. A carry cut with .detach() would make these zero
    _, port, jax_side = window
    want = np.asarray(jax_side["carry"])
    got = {s: g for s, g in enumerate(port["carry"])}
    assert len(got) == want.shape[0] - 1
    assert all(float(g.norm()) > 0 for g in got.values())
    assert _mixed_bar(got, {s: torch.from_numpy(want[s]) for s in got},
                      1e-4) == {}


def test_window_pool_matches_jax(windows):
    _, port, jax_side = windows("g3_dropout_pool")
    pool = port["pm"].pool
    # a batch-2 window of 4 frames through a 2-frame pool: it filled, and
    # the later frames swapped per JAX's decisions
    assert int(pool.count) == int(jax_side["pool"].count) == 2
    np.testing.assert_allclose(pool.buffer.numpy(),
                               np.asarray(jax_side["pool"].buffer),
                               atol=1e-6)


def test_frozen_trunk_keeps_the_carry_through_it(windows):
    # with the trunk frozen its parameters get no gradient, but the carry
    # still runs back through it: the enhancer's and D's gradients are
    # JAX's full ones (JAX zeroes the trunk's after the fact)
    _, _, jax_side = windows("temporal_512")
    port = port_step(CASES["temporal_512"], freeze_trunk=True)
    pm = port["pm"]
    want_g, want_d = state_dicts(pm, jax_side["grads"])
    got_g = {k: p.grad for k, p in pm.netG.named_parameters()}
    trunk = {k for k in got_g if k.startswith("model.")}
    assert trunk and all(got_g[k] is None for k in trunk)
    rest = {k: v for k, v in got_g.items() if k not in trunk}
    assert _mixed_bar(rest, {k: want_g[k] for k in rest}, 1e-4) == {}
    got_d = {k: p.grad for k, p in pm.netD.named_parameters()}
    assert _mixed_bar(got_d, {k: want_d[k] for k in got_d}, 1e-4) == {}
