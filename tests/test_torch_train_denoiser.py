"""The U-Net's weight I/O and the denoiser trainer of the port
(models/denoiser_unet.py save_params/load_params, tools/train_denoiser.py)
on the CPU, against the JAX package: each package reads the other's
weights with equal outputs, the loss and its gradients equal
jax.value_and_grad of the reference's loss, Adam under the cosine schedule
equals optax's, make_case builds the reference's scenes, cameras and
environments, and a short run on small pairs lowers the loss and writes
only where it is told."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import denoiser_unet as junet
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.models import denoiser_unet as tunet
from raytracer_project_tpu_torch.tools import train_denoiser as td

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(width=68, height=36, low=1, high=2)


def _buffers(n, h, w, seed):
    r = np.random.default_rng(seed)
    return (r.gamma(1.0, 0.5, (n, h, w, 3)).astype(np.float32),
            r.uniform(0.0, 1.0, (n, h, w, 3)).astype(np.float32),
            r.uniform(0.0, 1.0, (n, h, w, 3)).astype(np.float32),
            r.gamma(1.0, 0.5, (n, h, w, 3)).astype(np.float32))


def _close(out, ref):
    """The U-Net parity test's tolerance (tests/test_torch_denoise.py):
    max |d| <= 2e-5 of the output's largest value."""
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("source", ["tensors", "module"])
def test_port_weights_read_by_the_reference(tmp_path, source):
    """save_params of OIHW tensors (or DenoiserUNet.params()) writes the
    reference's layout bit for bit; the reference's load_params + apply
    gives the port's output."""
    params = (tunet.params_from_numpy(tunet.init_params(4)) if source == "tensors"
              else tunet.DenoiserUNet(seed=4).params())
    path = tmp_path / "w.npz"
    tunet.save_params(path, params)
    jparams = junet.load_params(str(path))
    for k, v in tunet.init_params(4).items():
        np.testing.assert_array_equal(np.asarray(jparams[k]), v)
    b, a, n, _ = _buffers(1, 37, 53, 1)
    ref = np.asarray(junet.apply(jparams, b[0], a[0], n[0]))
    with torch.no_grad():
        out = tunet.apply(params, *(torch.from_numpy(x[0]) for x in (b, a, n)))
    _close(out.numpy(), ref)


def test_reference_weights_read_by_the_port(tmp_path):
    path = tmp_path / "w.npz"
    jparams = {k: jnp.asarray(v) for k, v in junet.init_params(5).items()}
    junet.save_params(str(path), jparams)
    params = tunet.load_params(path)
    b, a, n, _ = _buffers(1, 36, 52, 2)
    ref = np.asarray(junet.apply(jparams, b[0], a[0], n[0]))
    with torch.no_grad():
        out = tunet.apply(params, *(torch.from_numpy(x[0]) for x in (b, a, n)))
    _close(out.numpy(), ref)


def test_loss_and_gradients_match_the_reference():
    """On fixed 32x64 crops (a batch of 3): the loss within 1e-5 relative,
    and every layer's weight and bias gradient within 1e-3 relative in
    norm, against jax.value_and_grad of the reference's loss (its vmap of
    apply, L1 on log1p)."""
    b, a, n, t = _buffers(3, td.PH, td.PW, 3)
    np_params = tunet.init_params(0)

    def jloss(p):
        pred = jax.vmap(lambda bb, aa, nn: junet.apply(p, bb, aa, nn))(b, a, n)
        return jnp.mean(jnp.abs(jnp.log1p(pred) - jnp.log1p(t)))

    jl, jg = jax.value_and_grad(jloss)({k: jnp.asarray(v)
                                        for k, v in np_params.items()})
    params = {k: v.requires_grad_(True)
              for k, v in tunet.params_from_numpy(np_params).items()}
    loss = td.loss_fn(params, *map(torch.from_numpy, (b, a, n, t)))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * float(jl)
    for name, _, _ in tunet._LAYERS:
        for k, to_port in ((f"{name}.w", (3, 2, 0, 1)), (f"{name}.b", (0,))):
            ref = np.asarray(jg[k]).transpose(to_port)
            got = params[k].grad.numpy()
            rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
            assert rel <= 1e-3, (k, rel)


def test_adam_under_the_cosine_schedule_matches_optax():
    """Three Adam steps of fixed gradients, 10-step cosine decay from 2e-3
    to 5%: the parameters equal optax.adam(cosine_decay_schedule)'s within
    1e-6, and the rate factor equals the schedule's."""
    steps = 10
    sched = optax.cosine_decay_schedule(td.LR, steps, alpha=td.ALPHA)
    for s in (0, 1, 5, 10, 12):
        assert td.LR * td.cosine_decay(s, steps) == pytest.approx(
            float(sched(s)), rel=1e-6)
    r = np.random.default_rng(4)
    p0 = {"w": r.normal(size=(4, 5)).astype(np.float32),
          "b": r.normal(size=(5,)).astype(np.float32)}
    grads = [{k: r.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    opt = optax.adam(sched)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt, tsched = td.optimizer(list(tp.values()), steps)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v)
        topt.step()
        tsched.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)


def _reference_make_case():
    """The reference trainer's make_case, lifted from its source with ast
    (importing tools/train_denoiser.py would run its script)."""
    src = (REPO / "tools" / "train_denoiser.py").read_text()
    fn = next(node for node in ast.parse(src).body
              if isinstance(node, ast.FunctionDef) and node.name == "make_case")
    ns = dict(np=np, presets=jpresets, cam_mod=jcam, env_mod=jenv, W=td.W,
              H=td.H)
    exec(compile(ast.Module([fn], []), "train_denoiser.py", "exec"), ns)
    return ns["make_case"]


def _jax_flat(obj, prefix=""):
    out = {}
    if obj is None:
        return out
    if hasattr(obj, "_fields"):
        for name, val in zip(obj._fields, obj):
            if name != "bvh":
                out.update(_jax_flat(val, f"{prefix}.{name}" if prefix else name))
        return out
    out[prefix] = np.asarray(obj)
    return out


def _assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].reshape(-1).view(np.uint8),
                                      b[k].reshape(-1).view(np.uint8), err_msg=k)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_make_case_builds_the_reference_case(i):
    """Scene tables, camera and environment bit for bit, and the env mode."""
    jscene, jc, je, jmode = _reference_make_case()(i)
    tscene, tc, te, tmode = td.make_case(i)
    _assert_bit_equal(_jax_flat(jscene), flatten(tscene))
    _assert_bit_equal({k: np.asarray(v) for k, v in jc._asdict().items()},
                      flatten(tc))
    _assert_bit_equal({k: np.asarray(v) for k, v in je._asdict().items()},
                      flatten(te))
    assert tmode == jmode


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """Pairs 0 and 1 (a Shirley scene, the Cornell box) at 68x36, 1 against
    2 spp, rendered on the CPU into a cache directory."""
    path = tmp_path_factory.mktemp("pairs")
    for i in (0, 1):
        td.get_pair(i, path, torch.device("cpu"), **SMALL)
    return path


def test_training_lowers_the_loss(cache):
    """20 steps on the two small pairs: the loss over their whole frames
    falls below the untrained network's; a cached pair reads back."""
    pairs = [td.get_pair(i, cache, torch.device("cpu"), **SMALL) for i in (0, 1)]
    full = [torch.from_numpy(np.stack([p[k] for p in pairs]))
            for k in ("beauty", "albedo", "normal", "target")]
    with torch.no_grad():
        before = float(td.loss_fn(tunet.DenoiserUNet(seed=0).params(), *full))
    model, losses = td.train(pairs, 20, torch.device("cpu"))
    assert len(losses) == 20 and np.isfinite(losses).all()
    with torch.no_grad():
        after = float(td.loss_fn(model.params(), *full))
    assert after < before, (before, after)


def test_main_writes_only_where_told(cache, tmp_path):
    """main refuses the JAX package's assets before rendering anything;
    given a path it trains, validates on the held-out pairs against the
    a-trous filter and the shipped weights, and writes weights that the
    reference reads."""
    assets = REPO / "raytracer_project_tpu" / "assets" / "denoiser_weights.npz"
    with pytest.raises(ValueError, match="refusing"):
        td.main(steps=1, pairs=3, out=assets, cache=cache, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="refusing"):
        td.main(steps=1, pairs=3, out=tmp_path / "w.npz",
                cache=assets.parent, device="cpu", **SMALL)
    res = td.main(steps=2, pairs=3, out=tmp_path / "w.npz", cache=cache,
                  device="cpu", **SMALL)
    assert len(res["losses"]) == 2 and len(res["val"]) == 2
    assert set(res["val"][0]) == {"raw", "atrous", "unet", "shipped"}
    assert junet.param_count(junet.load_params(str(res["out"]))) == \
        junet.param_count(junet.init_params(0))
