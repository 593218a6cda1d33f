"""The port's model families (``xaynet_tpu_torch.models``) against the JAX
package's, on the CPU, from the same weights and inputs.

Weights cross with ``convert.load_flax_params`` (by name) and
``convert.unflatten_params`` (the flat vector); inputs are made from numpy
seeds. What is held, per family (MLP, LeNet, CharLSTM, ResNet, LoRA):

- ``flatten_params`` of the carried-over weights is **byte-identical** to
  the JAX package's ``flatten_params`` (the masked vector's layout), the
  full-depth ResNet-50 (25,557,032 parameters, 161 leaves) included;
- the forward pass agrees, and one train step (the parameters after the
  family's Adam or SGD-momentum step on one batch) agrees. Tolerances:
  f32 paths are held to a few f32 roundings of their values (each test
  states its bound); ResNet's bf16 path to the JAX bf16 path's own
  distance from f32 (below);
- LoRA's ``quantize_deltas`` / ``dequantize_deltas`` are byte-identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xaynet_tpu.models import lenet as j_lenet
from xaynet_tpu.models import lora as j_lora
from xaynet_tpu.models import lstm as j_lstm
from xaynet_tpu.models import mlp as j_mlp
from xaynet_tpu.models import resnet as j_resnet
from xaynet_tpu_torch.convert import load_flax_params, unflatten_params
from xaynet_tpu_torch.models import lenet, lora, lstm, mlp, resnet
from xaynet_tpu_torch.models.federated import model_length

CPU = torch.device("cpu")
SMALL_RESNET = dict(num_classes=10, stage_sizes=(1, 1, 1, 1))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _resnet_params(stage_sizes, num_classes: int, seed: int):
    """Flax ResNet parameters with numpy values (no JAX init, which compiles
    the whole model): conv and Dense kernels N(0, 1/fan_in), GroupNorm scales
    1 + N(0, 0.01), biases N(0, 0.01)."""
    shapes = jax.eval_shape(
        lambda: j_resnet.init_params(
            jax.random.PRNGKey(0), num_classes=num_classes, stage_sizes=stage_sizes
        )
    )
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


class Family:
    """One family at a small size: JAX params and model, the port's module
    factory (fresh, unloaded), a batch, the JAX loss and optimizer."""

    def __init__(self, name, params, j_apply, t_module, x, y, j_loss, tx, t_steps):
        self.name, self.params, self.j_apply, self.t_module = name, params, j_apply, t_module
        self.x, self.y, self.j_loss, self.tx, self.t_steps = x, y, j_loss, tx, t_steps

    def port(self):
        return load_flax_params(self.t_module(), self.params)


def _mse(apply):
    return lambda p, x, y: jnp.mean((apply(p, x).squeeze(-1) - y) ** 2)


def _xent(apply):
    return lambda p, x, y: optax.softmax_cross_entropy_with_integer_labels(apply(p, x), y).mean()


def _family(name: str) -> Family:
    rng = np.random.default_rng(sum(map(ord, name)))
    key = jax.random.PRNGKey(len(name))
    if name == "mlp":
        model = j_mlp.MLP()
        x = rng.normal(size=(16, 13)).astype(np.float32)
        y = rng.normal(size=16).astype(np.float32)
        return Family(name, _np_tree(j_mlp.init_params(key, 13)), model.apply,
                      lambda: mlp.MLP(13), x, y, _mse(model.apply), optax.adam(1e-3),
                      mlp.make_train_step)  # fmt: skip
    if name == "lenet":
        model = j_lenet.LeNet()
        x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=4).astype(np.int32)
        return Family(name, _np_tree(j_lenet.init_params(key)), model.apply, lenet.LeNet, x, y,
                      _xent(model.apply), optax.sgd(1e-3, momentum=0.9), lenet.make_train_step)  # fmt: skip
    if name == "lstm":
        model = j_lstm.CharLSTM(hidden=32)
        x = rng.integers(0, 80, size=(4, 12)).astype(np.int32)
        y = rng.integers(0, 80, size=(4, 12)).astype(np.int32)
        return Family(name, _np_tree(j_lstm.init_params(key, seq_len=12, hidden=32)), model.apply,
                      lambda: lstm.CharLSTM(hidden=32), x, y, _xent(model.apply),
                      optax.adam(1e-3), lstm.make_train_step)  # fmt: skip
    dtype = {"resnet-f32": (jnp.float32, torch.float32), "resnet-bf16": (jnp.bfloat16, torch.bfloat16)}
    j_dtype, t_dtype = dtype[name]
    model = j_resnet.ResNet50(**SMALL_RESNET, dtype=j_dtype)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=4).astype(np.int32)
    return Family(name, _resnet_params((1, 1, 1, 1), 10, seed=3), model.apply,
                  lambda: resnet.ResNet50(**SMALL_RESNET, dtype=t_dtype), x, y,
                  _xent(model.apply), optax.sgd(0.1, momentum=0.9), resnet.make_train_step)  # fmt: skip


FAMILIES = ["mlp", "lenet", "lstm", "resnet-f32", "resnet-bf16"]
_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for torch here (the suite runs beside other
    workers); restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def family(request) -> Family:
    if request.param not in _CACHE:
        _CACHE[request.param] = _family(request.param)
    return _CACHE[request.param]


def _jax_step(fam: Family):
    """The parameters after one JAX step, and its loss (the JAX package's
    step: ``value_and_grad``, ``tx.update``, ``apply_updates``)."""

    @jax.jit
    def step(p, x, y):
        loss, grads = jax.value_and_grad(fam.j_loss)(p, x, y)
        updates, _ = fam.tx.update(grads, fam.tx.init(p), p)
        return optax.apply_updates(p, updates), loss

    params, loss = step(fam.params, fam.x, fam.y)
    return j_mlp.flatten_params(params), float(loss)


def _port_step(fam: Family, module=None):
    module = fam.port() if module is None else module
    _, optimizer_fn, step = fam.t_steps()
    loss = step(module, optimizer_fn(module.parameters()), fam.x, fam.y)
    return mlp.flatten_params(module), float(loss)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("family", FAMILIES, indirect=True)
def test_flatten_params_byte_identical(family):
    port = family.port()
    want = j_mlp.flatten_params(family.params)
    got = mlp.flatten_params(port)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert model_length(port) == want.size


@pytest.mark.parametrize("family", FAMILIES, indirect=True)
def test_unflatten_the_jax_vector_equals_loading_by_name(family):
    """The flat route: the JAX package's vector written into a fresh module
    gives the module ``load_flax_params`` gives, and flattens back to it."""
    vector = j_mlp.flatten_params(family.params)
    fresh = unflatten_params(family.t_module(), vector)
    assert mlp.flatten_params(fresh).tobytes() == vector.tobytes()
    by_name = family.port().state_dict()
    assert all(torch.equal(t, by_name[k]) for k, t in fresh.state_dict().items())
    with pytest.raises(ValueError, match="vector of"):
        unflatten_params(fresh, vector[:-1])


def test_resnet50_full_depth_layout():
    """ResNet-50 at full depth (constructed and loaded, not run): 161 leaves,
    25,557,032 parameters, in flax's sorted-key order, byte-identical."""
    params = _resnet_params((3, 4, 6, 3), 1000, seed=5)
    port = load_flax_params(resnet.init_params(torch.Generator().manual_seed(0), device=CPU), params)
    want = j_mlp.flatten_params(params)
    assert want.size == 25_557_032 == model_length(port) == resnet.param_count(port)
    assert mlp.flatten_params(port).tobytes() == want.tobytes()
    paths = [p for p, _ in mlp.leaves(port)]
    assert len(paths) == 161
    blocks = [p[0] for p in paths if p[0].startswith("Bottleneck")]
    assert blocks.index("Bottleneck_10") < blocks.index("Bottleneck_2")
    assert blocks[-1] == "Bottleneck_9"
    assert [p[0] for p in paths[-3:]] == ["Dense_0", "GroupNorm_0", "GroupNorm_0"]
    assert paths[:2] == [("Bottleneck_0", "Conv_0", "kernel"), ("Bottleneck_0", "Conv_1", "kernel")]


def test_char_lstm_default_size_is_flax_leaves():
    """The default CharLSTM (embedding 8, two layers of 256, 80 symbols) has
    exactly flax's 817,872 parameters, leaf for leaf."""
    params = jax.eval_shape(lambda: j_lstm.init_params(jax.random.PRNGKey(0), seq_len=4))
    module = lstm.init_params(torch.Generator().manual_seed(0), device=CPU)
    want = {tuple(k.key for k in p): tuple(s.shape)
            for p, s in jax.tree_util.tree_flatten_with_path(params["params"])[0]}  # fmt: skip
    assert {k: tuple(v.shape) for k, v in module.flax_leaves().items()} == want
    assert model_length(module) == 817_872 == sum(p.numel() for p in module.parameters())


# forward tolerances: f32 families to a few roundings of their outputs
# (measured: <= 4e-6 of logits up to 2); ResNet bf16 to 5% of the logits'
# norm (8 significant bits, rounded after each of ~20 layers; the JAX bf16
# path is itself 1.2% from its f32 path on these inputs)
FORWARD_TOL = {"mlp": 1e-5, "lenet": 1e-5, "lstm": 1e-5, "resnet-f32": 1e-4}


@pytest.mark.parametrize("family", FAMILIES, indirect=True)
def test_forward_agrees(family):
    want = np.asarray(family.j_apply(family.params, family.x), dtype=np.float32)
    with torch.no_grad():
        got = family.port()(torch.from_numpy(family.x)).float().numpy()
    assert got.shape == want.shape
    if family.name == "resnet-bf16":
        assert _rel(got, want) <= 0.05
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL[family.name])


@pytest.mark.parametrize("size", [29, 33])
def test_resnet_same_padding_at_odd_sides(size):
    """flax's "SAME" at odd sides pads symmetrically where an even side pads
    (0, 1): the f32 forward still agrees at 29x29 and 33x33."""
    params = _resnet_params((1, 1, 1, 1), 10, seed=7)
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(j_resnet.ResNet50(**SMALL_RESNET, dtype=jnp.float32).apply(params, x))
    port = load_flax_params(resnet.ResNet50(**SMALL_RESNET, dtype=torch.float32), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("family", FAMILIES, indirect=True)
def test_one_train_step_agrees(family):
    """The parameters after one step from the same weights and batch.

    - SGD families (LeNet, ResNet f32): the update is lr x gradient, held
      to 1e-5 absolute (measured <= 3e-7 of updates up to 0.17);
    - Adam families (MLP, LSTM): the first update is lr g / (|g| + eps),
      about lr wherever |g| >> eps, so the bound is 1% of lr (1e-5);
    - ResNet bf16: the update's norm-relative distance from the JAX bf16
      update is at most twice the JAX bf16 update's own distance from the
      JAX f32 update (the rounding noise of the path under test; measured
      7.6% against 14%).
    """
    p0 = j_mlp.flatten_params(family.params)
    want, want_loss = _jax_step(family)
    got, got_loss = _port_step(family)
    if family.name == "resnet-bf16":
        f32 = _family("resnet-f32")
        f32.params = family.params
        want_f32, _ = _jax_step(f32)
        bf16_noise = _rel(want - p0, want_f32 - p0)
        assert _rel(got - p0, want - p0) <= 2 * bf16_noise
        assert abs(got_loss - want_loss) <= 0.02 * abs(want_loss)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert abs(got_loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    assert np.abs(want - p0).max() > 1e-4  # the step moved the weights


@pytest.mark.parametrize("name", ["mlp", "lenet", "lstm"])
def test_init_params_draws_flax_distributions(name):
    """``init_params`` from a ``torch.Generator`` draws what flax's init
    draws, leaf by leaf: zero where flax is zero, and each random leaf's
    standard deviation within 15% of the JAX init's (lecun_normal kernels,
    orthogonal recurrent kernels, the embedding's N(0, 1/8)); the same
    generator seed gives the same module."""
    key = jax.random.PRNGKey(0)
    make = {
        "mlp": (lambda g: mlp.init_params(g, 13, device=CPU), lambda: j_mlp.init_params(key, 13)),
        "lenet": (lambda g: lenet.init_params(g, device=CPU), lambda: j_lenet.init_params(key)),
        "lstm": (lambda g: lstm.init_params(g, hidden=64, device=CPU),
                 lambda: j_lstm.init_params(key, seq_len=4, hidden=64)),
    }[name]  # fmt: skip
    port = make[0](torch.Generator().manual_seed(1))
    again = make[0](torch.Generator().manual_seed(1))
    assert mlp.flatten_params(port).tobytes() == mlp.flatten_params(again).tobytes()
    flax_leaves = {tuple(k.key for k in p): np.asarray(v) for p, v in
                   jax.tree_util.tree_flatten_with_path(make[1]()["params"])[0]}  # fmt: skip
    for path, view in port.flax_leaves().items():
        mine, theirs = view.detach().numpy(), flax_leaves[path]
        if not theirs.any():
            assert not mine.any(), path
        else:
            assert 0.85 < mine.std() / theirs.std() < 1.15, path


def test_resnet_init_params_draws_flax_distributions():
    """ResNet's init: conv and Dense kernels lecun_normal (std 1/sqrt(fan_in),
    cut at two standard deviations of the untruncated draw), GroupNorm
    scale 1 and bias 0, Dense bias 0."""
    port = resnet.init_params(torch.Generator().manual_seed(2), device=CPU, **SMALL_RESNET)
    for path, view in port.flax_leaves().items():
        v = view.detach().numpy()
        if path[-1] == "kernel":
            fan_in = np.prod(v.shape[:-1])
            assert 0.9 < v.std() * np.sqrt(fan_in) < 1.1, path
            assert np.abs(v).max() <= 2 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
        else:
            assert np.array_equal(v, np.ones_like(v) if path[-1] == "scale" else np.zeros_like(v))


# -- LoRA ---------------------------------------------------------------------

LORA_SPEC = dict(targets={"v": (12, 6), "q": (10, 8)}, rank=4)


def _lora_pair():
    j_adapters = _np_tree(j_lora.init_adapters(jax.random.PRNGKey(3), j_lora.LoraSpec(**LORA_SPEC)))
    # B = 0 at init: give it values so the deltas exercise every leaf
    rng = np.random.default_rng(3)
    for name in j_adapters:
        j_adapters[name]["B"] = rng.normal(size=j_adapters[name]["B"].shape).astype(np.float32) * 0.3
    t_adapters = {n: {k: torch.tensor(v, requires_grad=True) for k, v in a.items()}
                  for n, a in j_adapters.items()}  # fmt: skip
    return j_adapters, t_adapters


@pytest.mark.parametrize("scale", [10**4, 10**6])
def test_lora_quantize_dequantize_byte_identical(scale):
    j_adapters, t_adapters = _lora_pair()
    want = j_lora.quantize_deltas(j_adapters, scale)
    got = lora.quantize_deltas(t_adapters, scale)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    j_back = j_lora.dequantize_deltas(want, j_adapters, scale)
    t_back = lora.dequantize_deltas(got, t_adapters, scale)
    for name in j_adapters:
        for part in ("A", "B"):
            assert t_back[name][part].requires_grad
            assert (t_back[name][part].detach().numpy().tobytes()
                    == np.asarray(j_back[name][part]).tobytes())  # fmt: skip
    # flax's order: sorted names, then A, B
    order = [t_adapters[n][k] for n in ("q", "v") for k in ("A", "B")]
    assert all(a is b for a, b in zip(lora.adapter_leaves(t_adapters), order))


def test_lora_init_adapters():
    spec = lora.LoraSpec(**LORA_SPEC)
    adapters = lora.init_adapters(torch.Generator().manual_seed(0), spec, device=CPU)
    again = lora.init_adapters(torch.Generator().manual_seed(0), spec, device=CPU)
    for name, (d, k) in spec.targets.items():
        a, b = adapters[name]["A"], adapters[name]["B"]
        assert a.shape == (d, spec.rank) and b.shape == (spec.rank, k) and not b.any()
        assert a.requires_grad and b.requires_grad and torch.equal(a, again[name]["A"])
    a = torch.cat([adapters[n]["A"].detach().flatten() for n in spec.targets]) * spec.rank
    assert 0.7 < float(a.std()) < 1.3  # N(0, 1) / r


def test_lora_train_step_agrees():
    """One Adam step on the adapters over a frozen base (the example's
    loss): the adapters after it agree within 1% of lr (Adam's first update
    is about lr per element); only the adapters are updated."""
    j_adapters, t_adapters = _lora_pair()
    rng = np.random.default_rng(11)
    x = rng.normal(size=(32, 10)).astype(np.float32)
    base = rng.normal(size=(10, 8)).astype(np.float32)
    y = rng.normal(size=(32, 8)).astype(np.float32)

    def j_loss(adapters, batch):
        bx, by = batch
        pred = j_lora.apply_adapter(bx @ base, bx, adapters["q"], 16.0, 4)
        return jnp.mean((pred - by) ** 2)

    tx, j_step = j_lora.make_train_step(j_loss, learning_rate=1e-2)
    j_new, _, j_l = j_step(j_adapters, tx.init(j_adapters), (x, y))
    t_base = torch.from_numpy(base).requires_grad_()

    def t_loss(adapters, batch):
        bx, by = batch
        pred = lora.apply_adapter(bx @ t_base, bx, adapters["q"], 16.0, 4)
        return torch.mean((pred - by) ** 2)

    optimizer_fn, t_step = lora.make_train_step(t_loss, learning_rate=1e-2)
    t_l = t_step(t_adapters, optimizer_fn(t_adapters), (torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(t_l) - float(j_l)) <= 1e-5 * abs(float(j_l))
    assert np.array_equal(t_base.detach().numpy(), base)
    for part in ("A", "B"):
        np.testing.assert_allclose(t_adapters["q"][part].detach().numpy(),
                                   np.asarray(j_new["q"][part]), rtol=0, atol=1e-4)  # fmt: skip
    # "v" has no gradient in this loss: Adam leaves it where it was
    assert np.array_equal(t_adapters["v"]["A"].detach().numpy(), j_adapters["v"]["A"])
