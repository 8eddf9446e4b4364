"""The port's sampler extras against the JAX generator on the same weights
and initial noise (float32, the plain Denoiser on the CPU): the CFG
combine with guidance rescale and a guidance interval, Heun, eta-stochastic
DDIM and fresh-noise sampling (fed the JAX package's own noise stream),
the port's endpoint equalities and per-image streams, every ValueError of
the JAX generator's checks, the graph key of the step loop, and the
captured loop's static buffers and launch counts rehearsed with a stand-in
for the CUDA graph."""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_latent_diffusion_tpu.configs import DenoiserConfig
from transformer_latent_diffusion_tpu.models import Denoiser as JaxDenoiser
from transformer_latent_diffusion_tpu.sampling import diffusion as jd
from transformer_latent_diffusion_tpu.utils import init_denoiser_params
from transformer_latent_diffusion_tpu_torch import configs as pc
from transformer_latent_diffusion_tpu_torch import convert
from transformer_latent_diffusion_tpu_torch.models.denoiser import Denoiser
from transformer_latent_diffusion_tpu_torch.ops import fused_stack as fs
from transformer_latent_diffusion_tpu_torch.sampling import diffusion as td
from transformer_latent_diffusion_tpu_torch.sampling import graph as tg

torch.set_num_threads(2)

TINY = DenoiserConfig(image_size=16, embed_dim=64, n_layers=2, noise_embed_dims=64)
# float32 trajectories of a few denoiser calls: the two packages sum in
# other orders (measured rel-L2 ~1e-6 on the text-to-image slice)
TRAJ_REL_L2 = 1e-4


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def gens():
    jmodel = JaxDenoiser(**asdict(TINY))
    params = init_denoiser_params(jmodel, TINY)
    model = Denoiser.from_config(pc.DenoiserConfig(**asdict(TINY)))
    sd = convert.denoiser_state_dict(jax.tree.map(np.asarray, params), TINY)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return (jd.DiffusionGenerator(model=jmodel, params=params, vae=None),
            td.DiffusionGenerator(model.eval(), device="cpu"))


def _kw(n=2, seed=5):
    rng = np.random.default_rng(seed)
    labels = rng.standard_normal((n, 768)).astype(np.float32)
    noise = rng.standard_normal((n, 4, 16, 16)).astype(np.float32)
    return dict(labels=labels, num_imgs=n, img_size=16, seeds=noise, seed=seed,
                sharp_f=0, bright_f=0, class_guidance=5.0, n_iter=4)


def _both(gens, **kw):
    jgen, gen = gens
    _, want = jgen.generate(**kw)
    _, got = gen.generate(**kw)
    return got.numpy(), np.asarray(want)


# ------------------------------ the CFG combine ------------------------------


@pytest.mark.parametrize("rescale", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("interval", [None, (0.2, 0.8), (0.6, 0.9)],
                         ids=["no_interval", "active", "inactive"])
def test_cfg_combine_matches_jax(rescale, interval):
    """Per-image guidance, sigma 0.5 (inside (0.2, 0.8), outside (0.6,
    0.9)). float32: 2e-6 of the output's scale (the per-sample std is a
    reduction summed in another order). Also in the form `sample_loop`
    calls it, the options as device scalars read from `loop_scalars`,
    which is bit-equal to the float form."""
    rng = np.random.default_rng(0)
    cond, uncond = (rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
                    for _ in range(2))
    g = np.array([1.0, 3.0, 7.5], np.float32)
    want = np.asarray(jd.cfg_combine(
        jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(g),
        sigma=jnp.float32(0.5), cfg_rescale=rescale, guidance_interval=interval))
    args = (torch.from_numpy(cond), torch.from_numpy(uncond), torch.from_numpy(g))
    floats = td.cfg_combine(*args, sigma=0.5, cfg_rescale=rescale,
                            guidance_interval=interval).numpy()
    _, _, r, keep, lo, hi = torch.from_numpy(td.loop_scalars(
        cfg_rescale=rescale, guidance_interval=interval)).unbind(0)
    loop = td.cfg_combine(*args, sigma=torch.tensor(0.5),
                          cfg_rescale=(r, keep) if rescale else 0.0,
                          guidance_interval=None if interval is None else (lo, hi)).numpy()
    for got in (floats, loop):
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    np.testing.assert_array_equal(loop, floats)
    if interval == (0.6, 0.9):
        np.testing.assert_array_equal(want, cond)


# ------------------------------ the samplers against JAX ------------------------------


@pytest.mark.parametrize("extra", [
    dict(sampler="heun"), dict(sampler="heun", schedule="karras"),
    dict(cfg_rescale=0.7), dict(guidance_interval=(0.3, 0.9)),
    dict(sampler="ddim", cfg_rescale=0.5, guidance_interval=(0.0, 0.5))],
    ids=["heun", "heun_karras", "cfg_rescale", "guidance_interval", "both"])
def test_generate_matches_jax(gens, extra):
    """Heun, guidance rescale and the guidance interval through
    `generate`: final latents within TRAJ_REL_L2 of the JAX generator's."""
    got, want = _both(gens, **_kw(), **extra)
    assert _rel_l2(got, want) < TRAJ_REL_L2


def _jax_stream(seed, n, n_steps):
    """The JAX generator's fresh noise: image j, step i draws
    normal(fold_in(fresh_noise_image_keys(seed, n)[j], i))."""
    keys = jd.fresh_noise_image_keys(seed, n)
    return np.stack([np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(keys[j], i), (4, 16, 16), jnp.float32))
        for j in range(n)]) for i in range(n_steps)])


@pytest.mark.parametrize("extra", [dict(sampler="ddim", eta=0.5),
                                   dict(sampler="ddim", fresh_noise=True),
                                   dict(sampler="ddim", eta=1.0)],
                         ids=["eta_half", "fresh_noise", "eta_one"])
def test_stochastic_steps_fed_the_jax_stream_match_jax(gens, extra):
    """The port's seeds draw another stream than threefry, so the JAX
    stream goes into the port's loop function as its step-noise tensor:
    then the loop matches `generate` of the JAX package (TRAJ_REL_L2)."""
    jgen, gen = gens
    kw = _kw()
    _, want = jgen.generate(**kw, **extra)
    plan = gen.plan_loop(**{k: v for k, v in kw.items()
                            if k not in ("sharp_f", "bright_f")}, **extra)
    assert plan.inputs["step_noise"].shape == (3, 2, 4, 16, 16)
    plan.inputs["step_noise"] = torch.from_numpy(_jax_stream(kw["seed"], 2, 3))
    assert _rel_l2(plan.run_eager().numpy(), want) < TRAJ_REL_L2


def test_eta_endpoints_are_bit_equal(gens):
    """eta = 0 is the DDIM update, eta = 1 the fresh-noise path with the
    same per-image streams: both bit-equal."""
    gen = gens[1]
    kw = _kw()
    _, ddim = gen.generate(sampler="ddim", **kw)
    _, eta0 = gen.generate(sampler="ddim", eta=0.0, **kw)
    torch.testing.assert_close(eta0, ddim, atol=0, rtol=0)
    _, fresh = gen.generate(fresh_noise=True, use_ddpm_plus=False, **kw)
    _, eta1 = gen.generate(sampler="ddim", eta=1.0, **kw)
    torch.testing.assert_close(eta1, fresh, atol=0, rtol=0)
    _, mid = gen.generate(sampler="ddim", eta=0.5, **kw)
    _, other_seed = gen.generate(sampler="ddim", eta=0.5, **{**kw, "seed": 6})
    assert not torch.equal(mid, ddim) and not torch.equal(mid, fresh)
    assert not torch.equal(mid, other_seed)  # the seed moves the stream


def test_fresh_noise_streams_are_per_image(gens):
    """An image's stream is a function of (seed, j) alone: a request's
    images get the same step noise, bit for bit, solo and inside a larger
    batch (their own per-image seeds passed as fresh_noise_keys), and so
    the same images up to the denoiser's own batch dependence (the CPU's
    matmul blocking: TRAJ_REL_L2); the stream is not the initial noise of
    the same seed."""
    gen = gens[1]
    kw = {k: v for k, v in _kw(n=3).items() if k not in ("sharp_f", "bright_f")}
    seeds = td.fresh_noise_image_seeds(7, 3)
    assert seeds == td.fresh_noise_image_seeds(7, 5)[:3]
    batch = gen.plan_loop(sampler="ddim", eta=0.5, fresh_noise_keys=seeds, **kw)
    x_batch = batch.run_eager()
    for j in range(3):
        solo_kw = {**kw, "num_imgs": 1, "labels": kw["labels"][j:j + 1],
                   "seeds": kw["seeds"][j:j + 1]}
        solo = gen.plan_loop(sampler="ddim", eta=0.5,
                             fresh_noise_keys=seeds[j:j + 1], **solo_kw)
        torch.testing.assert_close(solo.inputs["step_noise"][:, 0],
                                   batch.inputs["step_noise"][:, j], atol=0, rtol=0)
        assert _rel_l2(solo.run_eager()[0], x_batch[j]) < TRAJ_REL_L2
    noise = td.draw_step_noise(td.fresh_noise_image_seeds(7, 1), 1, (4, 16, 16))
    init = torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(7))
    assert not torch.equal(noise[0], init)
    with pytest.raises(ValueError, match="fresh_noise_keys carries 2 keys for 3 images"):
        gen.plan_loop(sampler="ddim", eta=0.5, fresh_noise_keys=seeds[:2], **kw)


# ------------------------------ the checks ------------------------------


@pytest.mark.parametrize("bad,text", [
    (dict(sampler="euler_a"), "unknown sampler"),
    (dict(schedule="sigmoid"), "unknown noise schedule"),
    (dict(sampler="heun", init_latents=np.zeros((1, 4, 8, 8)),
          mask=np.ones((1, 4, 8, 8))), "inpainting"),
    (dict(sampler="heun", fresh_noise=True), "fresh_noise"),
    (dict(sampler="heun", cache_interval=2), "block caching"),
    (dict(sampler="ddim", eta=1.5), "eta must be in"),
    (dict(eta=0.5), "stochastic DDIM"),
    (dict(sampler="heun", eta=0.5), "stochastic DDIM"),
    (dict(sampler="ddim", eta=0.5, fresh_noise=True), "fresh_noise IS eta=1"),
    (dict(sampler="ddim", eta=0.5, init_latents=np.zeros((1, 4, 8, 8)),
          mask=np.ones((1, 4, 8, 8))), "inpainting"),
    (dict(cfg_rescale=1.5), "cfg_rescale must be in"),
    (dict(guidance_interval=(0.8, 0.2)), "guidance_interval must satisfy"),
], ids=["sampler", "schedule", "heun_mask", "heun_fresh", "heun_cache", "eta_range",
        "eta_dpm", "eta_heun", "eta_fresh", "eta_mask", "cfg_rescale", "interval"])
def test_value_errors_match_jax(gens, bad, text):
    """The JAX checks of tests/test_samplers.py and test_guidance.py: the
    same ValueError, with the same text, from both generators."""
    kw = dict(labels=np.ones((1, 768), np.float32), num_imgs=1, img_size=8, n_iter=4)
    for gen in gens:
        with pytest.raises(ValueError) as err:
            gen.generate(**kw, **bad)
        assert text in str(err.value)
    jax_text = str(pytest.raises(ValueError, gens[0].generate, **kw, **bad).value)
    assert str(pytest.raises(ValueError, gens[1].generate, **kw, **bad).value) == jax_text


def test_cache_interval_is_forced_to_one_under_noise(gens):
    """As in JAX: fresh_noise and eta force cache_interval to 1, and
    without an engine block caching warns and samples exactly."""
    gen = gens[1]
    kw = {k: v for k, v in _kw().items() if k not in ("sharp_f", "bright_f")}
    assert gen.plan_loop(sampler="ddim", eta=0.5, cache_interval=3,
                         **kw).spec.cache_interval == 1
    with pytest.warns(UserWarning, match="falling back to exact sampling"):
        assert gen.plan_loop(sampler="ddim", cache_interval=3,
                             **kw).spec.cache_interval == 1


# ------------------------------ the graph's key and static buffers ------------------------------


def test_graph_key_holds_branches_not_values(gens):
    """Calls that differ only in levels, schedule, shift, DDIM/DPM++,
    guidance, seed or the options' values map to one key; another step
    branch, option set, step count or shape to another."""
    gen = gens[1]
    kw = {k: v for k, v in _kw().items() if k not in ("sharp_f", "bright_f")}

    def key(**extra):
        return gen.plan_loop(**{**kw, **extra}).key

    base = key(sampler="ddim")
    for extra in (dict(sampler="dpm"), dict(schedule="karras"), dict(exponent=2.0),
                  dict(schedule_shift=2.0), dict(class_guidance=2.0), dict(seed=9),
                  dict(sampler="dpm", schedule="cosine")):
        assert key(**extra) == base, extra
    assert key(sampler="ddim", eta=0.3) == key(sampler="ddim", eta=0.7)
    assert key(cfg_rescale=0.3) == key(cfg_rescale=0.9)
    assert key(guidance_interval=(0.1, 0.5)) == key(guidance_interval=(0.4, 0.6))
    assert key(sampler="ddim", eta=1.0) == key(sampler="ddim", fresh_noise=True)
    others = [key(sampler="heun"), key(sampler="ddim", eta=0.5),
              key(sampler="ddim", eta=1.0), key(cfg_rescale=0.5),
              key(guidance_interval=(0.1, 0.5)), key(n_iter=5),
              key(num_imgs=1, labels=kw["labels"][:1], seeds=kw["seeds"][:1])]
    assert len({base, *others}) == len(others) + 1
    plan = gen.plan_loop(sampler="dpm", **kw)
    assert plan.inputs["levels"].dtype == torch.float32
    np.testing.assert_array_equal(plan.inputs["levels"].numpy(),
                                  td.make_noise_levels(4).astype(np.float32))
    np.testing.assert_array_equal(
        plan.inputs["scalars"].numpy(),
        np.array([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], np.float32))


class _FakeGraph:
    """A stand-in for torch.cuda.CUDAGraph on the CPU: capture records the
    function and its static inputs, a replay reruns it into the captured
    output (what a graph does to the buffers it holds)."""
    capturing = None

    def __init__(self):
        self.fn = self.out = None

    def replay(self):
        self.out.copy_(self.fn())


class _FakeCapture:
    def __init__(self, graph, **kw):
        self.graph = graph

    def __enter__(self):
        _FakeGraph.capturing = self.graph

    def __exit__(self, *exc):
        _FakeGraph.capturing = None


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def wait_stream(self, other):
        pass


def _fake_cuda(monkeypatch):
    """Stand-ins for the CUDA graph API on the CPU; returns the list of
    streams made."""
    made = []
    monkeypatch.setattr(tg, "_STREAMS", {})
    monkeypatch.setattr(tg.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tg.torch.cuda, "Stream", lambda: made.append(_Null()) or made[-1])
    monkeypatch.setattr(tg.torch.cuda, "stream", lambda s: _Null())
    monkeypatch.setattr(tg.torch.cuda, "current_stream", _Null)
    monkeypatch.setattr(tg.torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(tg.torch.cuda, "graph", _FakeCapture)
    return made


def _graph_fn(plan):
    """The loop as `run_plan` hands it to `LoopGraphs`, with a kernel
    wrapper's count of 5 launches a call (ticking under capture too)."""
    def fn(**inputs):
        fs.LAUNCHES["ln_gemm"] += 5
        if _FakeGraph.capturing is not None:  # record, as a capture does
            graph = _FakeGraph.capturing
            graph.fn = lambda: td.sample_loop(plan.spec, plan.forward, **inputs)
            graph.out = graph.fn()
            return graph.out
        return td.sample_loop(plan.spec, plan.forward, **inputs)
    return fn


def test_loop_graphs_static_buffers_and_counts(gens, monkeypatch):
    """`LoopGraphs` rehearsed on the CPU with a stand-in graph, as the
    CUDA branch of `generate` calls it: a key's first call runs eagerly,
    its second captures, and calls that share a key replay on their own
    inputs (the plain loop's result, bit-equal); the capture's kernel
    counts are taken back and a replay's added; at most `MAX_GRAPHS`
    graphs and as many keys seen once are kept, so a cycle of more keys
    than that never captures; one stream for every capture."""
    made = _fake_cuda(monkeypatch)
    monkeypatch.setattr(tg, "MAX_GRAPHS", 2)
    gen = gens[1]
    graphs = tg.LoopGraphs()
    kw = {k: v for k, v in _kw().items() if k not in ("sharp_f", "bright_f")}

    def run(plan):
        return graphs.run(plan.key, _graph_fn(plan), plan.inputs)

    fs.reset_launch_counts()
    for n, extra in enumerate((dict(sampler="ddim"),
                               dict(sampler="dpm", seed=8, class_guidance=2.0),
                               dict(sampler="ddim", schedule="karras"))):
        plan = gen.plan_loop(**{**kw, **extra})
        torch.testing.assert_close(run(plan), plan.run_eager(), atol=0, rtol=0)
        assert (graphs.captures, graphs.replays) == (min(n, 1), n)
    assert len(graphs) == 1
    assert fs.LAUNCHES["ln_gemm"] == 15  # 5 a call, none for the capture
    heun, rescale = (gen.plan_loop(**{**kw, **extra})
                     for extra in (dict(sampler="heun"), dict(cfg_rescale=0.5)))
    for plan in (heun, rescale, heun, rescale):
        run(plan)
    assert (graphs.captures, len(graphs)) == (3, 2)  # the first key dropped
    cycle = [gen.plan_loop(**{**kw, "n_iter": n}) for n in (3, 5, 6)]
    for plan in cycle + cycle + cycle:
        run(plan)
    assert graphs.captures == 3 and len(made) == 1


def test_loop_graphs_capture_that_raises_restores_counts(gens, monkeypatch):
    """A capture that raises propagates (nothing reruns the loop) and
    leaves the kernels' counts as they were: the launches counted under
    the failed capture ran nowhere."""
    _fake_cuda(monkeypatch)
    plan = gens[1].plan_loop(**{k: v for k, v in _kw().items()
                                if k not in ("sharp_f", "bright_f")})
    graphs = tg.LoopGraphs()

    def fn(**inputs):
        fs.LAUNCHES["ln_gemm"] += 5
        if _FakeGraph.capturing is not None:
            raise RuntimeError("capture failed")
        return td.sample_loop(plan.spec, plan.forward, **inputs)

    fs.reset_launch_counts()
    graphs.run(plan.key, fn, plan.inputs)
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.run(plan.key, fn, plan.inputs)
    assert fs.LAUNCHES["ln_gemm"] == 5 and graphs.captures == 0


def test_captured_loop_holds_no_plan(gens, monkeypatch):
    """The loop `run_plan` hands to the graphs (which a captured graph
    keeps) holds the plan's denoiser calls, not the plan and its inputs
    (the initial noise, the step noise)."""
    import weakref

    gen = td.DiffusionGenerator(gens[1].model, device="cpu")
    kept = []

    def run(key, fn, inputs):
        kept.append(fn)
        return fn(**inputs)

    monkeypatch.setattr(gen.graphs, "run", run)
    kw = {k: v for k, v in _kw().items() if k not in ("sharp_f", "bright_f")}
    plan = gen.plan_loop(sampler="ddim", eta=0.5, **kw)
    want = plan.run_eager()
    gen.device = torch.device("cuda")  # take the CUDA branch of run_plan
    torch.testing.assert_close(gen.run_plan(plan), want, atol=0, rtol=0)
    alive = [weakref.ref(t) for t in plan.inputs.values()] + [weakref.ref(plan)]
    del plan
    assert len(kept) == 1 and all(ref() is None for ref in alive)


def test_weight_change_repacks_and_drops_graphs():
    """The engine's packed weights are kept between calls while the model's
    parameters stay as they are; a `load_state_dict` packs again and drops
    the captured graphs (which read the weights by address), so the next
    call gives the new weights' result on every route."""
    from transformer_latent_diffusion_tpu_torch.models.fast_denoiser import make_fused_apply
    from transformer_latent_diffusion_tpu_torch.utils.common import init_random_weights_

    cfg = pc.DenoiserConfig(**asdict(TINY))
    model = init_random_weights_(Denoiser.from_config(cfg), 0).eval()
    gen = td.DiffusionGenerator(model, fast_apply=make_fused_apply(
        cfg, compute_dtype=torch.float32), device="cpu")
    kw = {k: v for k, v in _kw().items() if k not in ("sharp_f", "bright_f")}
    first = gen.plan_loop(sampler="ddim", **kw)
    packed = gen._weights[1]["engine"]
    assert gen.plan_loop(sampler="ddim", **kw) is not first
    assert gen._weights[1]["engine"] is packed  # kept while the weights stay
    gen.graphs._graphs["captured"] = object()
    other = init_random_weights_(Denoiser.from_config(cfg), 1)
    model.load_state_dict(other.state_dict())
    plan = gen.plan_loop(sampler="ddim", **kw)
    assert len(gen.graphs) == 0 and gen._weights[1]["engine"] is not packed
    fresh = td.DiffusionGenerator(other.eval(), fast_apply=make_fused_apply(
        cfg, compute_dtype=torch.float32), device="cpu")
    torch.testing.assert_close(plan.run_eager(),
                               fresh.plan_loop(sampler="ddim", **kw).run_eager(),
                               atol=0, rtol=0)
    gen.graphs._graphs["captured"] = object()
    with torch.no_grad():  # the linen route (no engine) checks the weights too
        model.denoiser_trans_block.pos_embed.weight.mul_(2.0)
    gen.plan_loop(sampler="ddim", **{**kw, "img_size": 8, "seeds": kw["seeds"][..., :8, :8]})
    assert len(gen.graphs) == 0


@pytest.mark.parametrize("img_size", [16, 8], ids=["native", "resized_table"])
def test_generator_with_graphs_is_freed_by_reference_count(gens, img_size):
    """A captured graph keeps its plan's denoiser call; that call must not
    hold the generator, or a dropped generator (and its graphs' device
    memory) would wait for the cycle collector."""
    import gc
    import weakref

    model = gens[1].model
    gen = td.DiffusionGenerator(model, device="cpu")
    kw = {k: v for k, v in _kw().items() if k not in ("sharp_f", "bright_f")}
    plan = gen.plan_loop(sampler="ddim", **{**kw, "img_size": img_size,
                                           "seeds": kw["seeds"][..., :img_size, :img_size]})
    gen.graphs._graphs[plan.key] = plan  # what a captured entry holds
    alive = weakref.ref(gen)
    gc.disable()
    try:
        del gen, plan
        assert alive() is None
    finally:
        gc.enable()
