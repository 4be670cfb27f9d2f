"""The port does everything the JAX package does: every public module,
function, class and method of ``multimodal_idbn_tpu`` (read from its
sources' ASTs) has a counterpart of the same name in
``multimodal_idbn_tpu_torch`` whose parameter names include the JAX
one's. Beyond names, a call that is valid in JAX is valid on the port and
means the same: every name a JAX package ``__init__`` exports imports
from the port's counterpart, JAX's positional parameters are a prefix of
the port's, in order, every JAX default is the port's default, and the
models built small on the CPU carry every public instance attribute of
JAX's. Each comparison lists its exceptions, each with its reason; a
listed exception that is no longer needed fails the test too, so the
lists stay true.
"""

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "multimodal_idbn_tpu"

# JAX module -> the port's module of the same job under another name.
RENAMED = {
    "ops/pallas_cd.py": "ops/fast_cd.py",
    "ops/pallas_chain.py": "ops/chain.py",
    "ops/pallas_kernels.py": "ops/half_step.py",
}

_TPU = "a TPU/XLA switch: the port always runs its CUDA kernels on the card"
_NO_LIMIT = ("the CUDA kernels take every shape, so no dispatcher asks "
             "whether one is supported")
_TILES = ("TPU block sizes: the port's kernels choose their tiling from the "
          "shape (half_step.plan)")
_AXIS = ("the port's meshes have one data axis, which the mesh names; no "
         "axis name is passed")

# "module:name" or "module:name(param)" -> why the port has none.
EXCEPTIONS = {
    "config.py": "the JAX runtime switches; the port's counterpart of "
                 "set_matmul_precision is device.set_matmul_precision",
    "config.py:enable_pallas_chain": _TPU,
    "config.py:pallas_chain_enabled": _TPU,
    "config.py:enable_pallas_cd": _TPU,
    "config.py:pallas_cd_enabled": _TPU,
    "config.py:set_matmul_precision": "device.set_matmul_precision",
    "config.py:enable_persistent_compilation_cache":
        "XLA's compilation cache; the port builds its kernels once per "
        "source hash into _build/",
    "checkpoint/__init__.py:save_checkpoint_orbax":
        "needs orbax; the port's counterpart is save_checkpoint_torch",
    "checkpoint/__init__.py:load_checkpoint_orbax":
        "needs orbax; the port's counterpart is load_checkpoint_torch",
    "models/rbm.py:as_array": "device.as_tensor, which also places the "
                              "tensor on the model's device",
    "models/rbm.py:RBM.state": "an instance attribute of the port's RBM, "
                               "a property of JAX's",
    "ops/dbn_train.py:idbn_epoch(shard_axis)": _AXIS,
    "ops/dbn_train.py:idbn_epoch_block(shard_axis)": _AXIS,
    "ops/imdbn_ops.py:joint_epoch(shard_axis)": _AXIS,
    "ops/imdbn_ops.py:joint_epoch_block(shard_axis)": _AXIS,
    "ops/bimodal_ops.py:bimodal_joint_epoch(shard_axis)": _AXIS,
    "ops/bimodal_ops.py:bimodal_epoch_block(shard_axis)": _AXIS,
    "ops/pallas_chain.py:chain_kernel_supported": _NO_LIMIT,
    "ops/pallas_chain.py:conditional_gibbs_fast":
        "rbm_ops.conditional_gibbs runs the chain kernel on the card",
    "ops/pallas_chain.py:noisy_meanfield_fast":
        "rbm_ops.noisy_meanfield_annealed runs the chain kernel on the card",
    "ops/pallas_chain.py:conditional_gibbs_reference": "chain.chain_plain",
    "ops/pallas_kernels.py:pallas_supported": _NO_LIMIT,
    "ops/pallas_kernels.py:sampled_cd_supported": _NO_LIMIT,
    "ops/pallas_kernels.py:hidden_probs_pallas":
        "half_step.hidden_probs_kernel",
    "ops/pallas_kernels.py:reference_half_step":
        "half_step.half_step_probs_plain",
    "ops/pallas_kernels.py:half_step_sample_aligned":
        "half_step.half_step_sample, which takes any shape unpadded",
    "ops/pallas_kernels.py:half_step_sample(v)":
        "JAX's half_step_sample is the port's half_step_sample_resident; "
        "the port's half_step_sample is JAX's half_step_sample_aligned",
    "ops/pallas_kernels.py:half_step_sample(block_m)": _TILES,
    "ops/pallas_kernels.py:half_step_sample(block_n)": _TILES,
    "ops/pallas_kernels.py:half_step_probs(block_m)": _TILES,
    "ops/pallas_kernels.py:half_step_probs(block_n)": _TILES,
    "ops/pallas_kernels.py:half_step_sample_big(block_m)": _TILES,
    "ops/pallas_kernels.py:half_step_sample_big(block_n)": _TILES,
    "ops/pallas_kernels.py:half_step_sample_big(block_k)": _TILES,
}


def _params(fn_node):
    a = fn_node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _jax_surface():
    """[(module path, name, JAX parameter names or None, class name)] of
    every public module-level function and class and every public method
    (and ``__init__``) of a public class."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        out.append((rel, None, None, None))
        for node in ast.parse(path.read_text()).body:
            if node.name.startswith("_") if hasattr(node, "name") else True:
                continue
            if isinstance(node, ast.FunctionDef):
                out.append((rel, node.name, _params(node), None))
            elif isinstance(node, ast.ClassDef):
                out.append((rel, node.name, None, None))
                for m in node.body:
                    if isinstance(m, ast.FunctionDef) and (
                            not m.name.startswith("_")
                            or m.name == "__init__"):
                        out.append((rel, m.name, _params(m), node.name))
    return out


def _port_module(rel):
    rel = RENAMED.get(rel, rel)
    name = rel[:-3].replace("/", ".")
    if name.endswith(".__init__"):
        name = name[:-len(".__init__")]
    if name == "__init__":
        return importlib.import_module("multimodal_idbn_tpu_torch")
    try:
        return importlib.import_module(f"multimodal_idbn_tpu_torch.{name}")
    except ModuleNotFoundError:
        return None


def _port_params(obj):
    if isinstance(obj, property):
        return None
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _gaps():
    gaps = set()
    for rel, name, params, cls in _jax_surface():
        mod = _port_module(rel)
        if name is None:
            if mod is None:
                gaps.add(rel)
            continue
        if mod is None:
            gaps.add(f"{rel}:{name}")
            continue
        owner = getattr(mod, cls, None) if cls else mod
        label = f"{rel}:{cls}.{name}" if cls else f"{rel}:{name}"
        if owner is None or not hasattr(owner, name):
            gaps.add(label)
            continue
        have = _port_params(inspect.getattr_static(owner, name)
                            if cls else getattr(owner, name))
        if params is None or have is None:
            continue
        gaps.update(f"{label}({p})" for p in params if p not in have)
    return gaps


def test_every_jax_name_has_a_port_counterpart():
    gaps = _gaps()
    missing = sorted(g for g in gaps if g not in EXCEPTIONS
                     and g.split(":")[0] not in EXCEPTIONS)
    assert not missing, f"no counterpart in the port: {missing}"


def test_every_exception_is_still_needed():
    gaps = _gaps()
    stale = sorted(e for e in EXCEPTIONS if e not in gaps
                   and not any(g.startswith(e + ":") for g in gaps))
    assert not stale, f"listed as exceptions but ported: {stale}"


@pytest.mark.parametrize("rel", ["parallel/__init__.py",
                                 "parallel/distributed.py",
                                 "parallel/data_parallel.py",
                                 "parallel/mesh2d.py"])
def test_parallel_modules_are_ported(rel):
    assert _port_module(rel) is not None
    assert not [g for g in _gaps() if g.startswith(rel)]


def test_surface_is_read():
    surface = _jax_surface()
    assert len(surface) > 200
    assert ("models/idbn.py", "train", ["epochs", "log_every_pca",
                                        "log_every_probe", "fused",
                                        "start_epoch", "checkpoint_every",
                                        "checkpoint_path",
                                        "checkpoint_phase"], "iDBN") \
        in surface


# -- a JAX-valid call is valid on the port, and means the same -------------

# "package/__init__.py:name" -> why the port's counterpart does not export
# it. None at present.
EXPORT_EXCEPTIONS: dict = {}

# "module:[Class.]function" -> why JAX's positional parameters are not a
# prefix of the port's.
POSITIONAL_EXCEPTIONS = {
    "ops/pallas_kernels.py:half_step_sample":
        "JAX's half_step_sample is the port's half_step_sample_resident "
        "(EXCEPTIONS above)",
}

# "module:[Class.]function(param)" -> why the port's default differs from
# JAX's (a parameter JAX requires may have a default on the port).
DEFAULT_EXCEPTIONS = {
    "ops/imdbn_ops.py:joint_epoch_block(n_epochs)":
        "None is the number of epoch indices: JAX sizes its scan with the "
        "static n_epochs, the port's loop needs no count, and any n_epochs "
        "given must equal the count, as JAX's 1 must",
    "ops/bimodal_ops.py:bimodal_epoch_block(n_epochs)":
        "None is the number of epoch indices (as joint_epoch_block)",
    "utils/profiling.py:trace(log_dir)":
        "the port writes its traces under the caller's directory and "
        "nothing outside it; JAX's default is a fixed /tmp path",
}

# "Class.attribute" -> why a port model lacks a public instance attribute
# of its JAX counterpart. None at present.
ATTRIBUTE_EXCEPTIONS: dict = {}


def _jax_exports():
    """[(package __init__ path, name)] of every name a JAX package
    ``__init__`` imports from the package or lists in ``__all__``."""
    out = []
    for path in sorted(JAX_PKG.rglob("__init__.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        names = set()
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, ast.ImportFrom) and node.level == 0
                    and node.module.split(".")[0] == JAX_PKG.name):
                names |= {a.asname or a.name for a in node.names}
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "__all__"
                    for t in node.targets):
                names |= set(ast.literal_eval(node.value))
        out.extend((rel, n) for n in sorted(names))
    return out


def _jax_functions():
    """[(label, ast.FunctionDef, port object)] of every public function
    and method (and ``__init__``) of the JAX package with a counterpart."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        mod = _port_module(rel)
        if mod is None:
            continue
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef) and \
                    not node.name.startswith("_"):
                if hasattr(mod, node.name):
                    out.append((f"{rel}:{node.name}", node,
                                getattr(mod, node.name)))
            elif isinstance(node, ast.ClassDef) and \
                    not node.name.startswith("_"):
                owner = getattr(mod, node.name, None)
                for m in node.body:
                    if (isinstance(m, ast.FunctionDef) and owner is not None
                            and (not m.name.startswith("_")
                                 or m.name == "__init__")
                            and hasattr(owner, m.name)):
                        obj = inspect.getattr_static(owner, m.name)
                        obj = getattr(obj, "__func__", obj)
                        out.append((f"{rel}:{node.name}.{m.name}", m, obj))
    return out


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _positional(params):
    return [n for n, p in params.items()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and n not in ("self", "cls")]


def _export_gaps():
    gaps = set()
    for rel, name in _jax_exports():
        mod = _port_module(rel)
        if mod is None or not hasattr(mod, name):
            gaps.add(f"{rel}:{name}")
    return gaps


def _positional_gaps():
    gaps = {}
    for label, node, obj in _jax_functions():
        sig = _signature(obj)
        if sig is None:
            continue
        a = node.args
        want = [x.arg for x in a.posonlyargs + a.args
                if x.arg not in ("self", "cls")]
        have = _positional(sig.parameters)
        if have[:len(want)] != want:
            gaps[label] = (want, have)
    return gaps


def _same_default(jax_node, port_default) -> bool:
    """JAX's default (an AST node) equals the port's value: literals by
    value, dtypes by name (``jnp.float32`` is ``torch.float32``)."""
    if port_default is inspect.Parameter.empty:
        return False
    try:
        return ast.literal_eval(jax_node) == port_default
    except ValueError:
        return (ast.unparse(jax_node).replace("jnp.", "torch.")
                == repr(port_default))


def _default_gaps():
    gaps = {}
    for label, node, obj in _jax_functions():
        sig = _signature(obj)
        if sig is None:
            continue
        a = node.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
        pairs += [(x, d) for x, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            p = sig.parameters.get(arg.arg)
            if p is not None and not _same_default(default, p.default):
                gaps[f"{label}({arg.arg})"] = (ast.unparse(default),
                                               p.default)
    return gaps


def _small_models():
    """{class name: (JAX instance, port instance)}, built small on the
    CPU from the same loaders and seeds."""
    import multimodal_idbn_tpu as J

    import multimodal_idbn_tpu_torch as T
    from torch_parity import (BIMODAL_JOINT, IMG_LAYERS, JOINT_HIDDEN, K,
                              MOD1_LAYERS, MOD2_LAYERS, SMALL_PARAMS,
                              small_loaders)
    train, val, _ = small_loaders()
    btrain, bval, _ = small_loaders(bimodal=True)
    kw = dict(params=dict(SMALL_PARAMS), dataloader=train, val_loader=val,
              num_labels=K, seed=0)
    bkw = dict(params=dict(SMALL_PARAMS), dataloader=btrain,
               val_loader=bval, seed=0)
    return {
        "RBM": (J.RBM(20, 10, 0.1, 1e-4, 0.5, seed=0),
                T.RBM(20, 10, 0.1, 1e-4, 0.5, seed=0, device="cpu")),
        "iDBN": (J.iDBN(IMG_LAYERS, dict(SMALL_PARAMS), train, val, seed=0),
                 T.iDBN(IMG_LAYERS, dict(SMALL_PARAMS), train, val,
                        device="cpu", seed=0)),
        "iMDBN": (J.iMDBN(IMG_LAYERS, JOINT_HIDDEN, **kw),
                  T.iMDBN(IMG_LAYERS, JOINT_HIDDEN, device="cpu", **kw)),
        "iMDBN_BiModal": (
            J.iMDBN_BiModal(MOD1_LAYERS, MOD2_LAYERS, BIMODAL_JOINT, **bkw),
            T.iMDBN_BiModal(MOD1_LAYERS, MOD2_LAYERS, BIMODAL_JOINT,
                            device="cpu", **bkw)),
    }


@pytest.fixture(scope="module")
def small_models():
    return _small_models()


def _attribute_gaps(models):
    return {f"{cls}.{a}" for cls, (j, t) in models.items()
            for a in vars(j) if not a.startswith("_")
            and not hasattr(t, a)}


@pytest.mark.parametrize("check", ["missing", "stale"])
@pytest.mark.parametrize("kind", ["exports", "positional", "defaults"])
def test_jax_calls_bind_the_same_on_the_port(kind, check):
    """(a) re-exports, (b) positional order, (c) defaults: the gaps are
    exactly the listed exceptions."""
    gaps, listed = {
        "exports": (_export_gaps, EXPORT_EXCEPTIONS),
        "positional": (_positional_gaps, POSITIONAL_EXCEPTIONS),
        "defaults": (_default_gaps, DEFAULT_EXCEPTIONS),
    }[kind]
    gaps = gaps()
    if check == "missing":
        bad = {g: (gaps[g] if isinstance(gaps, dict) else None)
               for g in gaps if g not in listed}
        assert not bad, f"JAX-valid calls that differ on the port: {bad}"
    else:
        stale = sorted(e for e in listed if e not in gaps)
        assert not stale, f"listed as exceptions but repaired: {stale}"


def test_instance_attributes_match(small_models):
    """(d) Every public instance attribute of JAX's RBM, iDBN, iMDBN and
    iMDBN_BiModal is set on the port's, built small on the CPU; the
    values that are plain data are equal."""
    gaps = _attribute_gaps(small_models)
    assert gaps == set(ATTRIBUTE_EXCEPTIONS), sorted(
        gaps ^ set(ATTRIBUTE_EXCEPTIONS))
    for cls, (j, t) in small_models.items():
        for a, v in vars(j).items():
            if a.startswith("_") or not isinstance(
                    v, (bool, int, float, str)) or a == "device":
                continue
            assert getattr(t, a) == v, (cls, a, getattr(t, a), v)


def test_surface_checks_read_the_sources():
    """The comparisons above see the JAX surface they claim to."""
    exports = _jax_exports()
    assert ("ops/__init__.py", "sample_visible") in exports
    assert len([e for e in exports if e[0] == "ops/__init__.py"]) == 17
    assert ("__init__.py", "__version__") in exports
    labels = {label for label, _, _ in _jax_functions()}
    assert {"models/imdbn.py:iMDBN.__init__", "ops/dbn_train.py:idbn_epoch",
            "ops/imdbn_ops.py:joint_train_batch_step"} <= labels


def test_imdbn_constructor_forms():
    """Both JAX constructor forms (models/imdbn.py:57-65): an int second
    argument is the joint width; a list is the legacy text sizes and
    needs ``joint_layer_size``; ``text_posenc_dim`` and ``embedding_dim``
    are accepted and unused. A positional call binds as in JAX."""
    from torch_parity import IMG_LAYERS, SMALL_PARAMS

    from multimodal_idbn_tpu_torch import iMDBN
    kw = dict(params=dict(SMALL_PARAMS), device="cpu", num_labels=6, seed=0)
    short = iMDBN(IMG_LAYERS, 20, **kw)
    legacy = iMDBN(IMG_LAYERS, [40, 30], joint_layer_size=20,
                   text_posenc_dim=8, embedding_dim=16, **kw)
    positional = iMDBN(IMG_LAYERS, [40, 30], 20, dict(SMALL_PARAMS), None,
                       None, "cpu", 0, 6, seed=0)
    for m in (short, legacy, positional):
        assert (m.joint_rbm.num_visible, m.joint_rbm.num_hidden) == (
            IMG_LAYERS[-1] + 6, 20)
        assert m.arch_str == short.arch_str
    for a, b in ((legacy, short), (positional, short)):
        assert torch.equal(a.joint_rbm.W, b.joint_rbm.W)
    with pytest.raises(ValueError, match="joint_layer_size required"):
        iMDBN(IMG_LAYERS, [40, 30], **kw)


def test_positional_calls_bind_as_in_jax():
    """The calls of fault 2: a run object passed positionally to the
    iDBN / bimodal constructors is the run, not a seed; RBM's positional
    dtype is the dtype; the iDBN epoch functions take lr, mom,
    weight_decay and sparsity_factor positionally and default to JAX's
    jnp route (fast_sampler False)."""
    from torch_parity import (BIMODAL_JOINT, IMG_LAYERS, MOD1_LAYERS,
                              MOD2_LAYERS, SMALL_PARAMS)

    from multimodal_idbn_tpu_torch import RBM, iDBN, iMDBN_BiModal
    from multimodal_idbn_tpu_torch.ops import dbn_train, rbm_ops
    from multimodal_idbn_tpu_torch.utils.wandb_compat import RecorderRun
    run = RecorderRun()
    dbn = iDBN(IMG_LAYERS, dict(SMALL_PARAMS), None, None, "cpu", run)
    assert dbn.wandb_run is run
    bi = iMDBN_BiModal(MOD1_LAYERS, MOD2_LAYERS, BIMODAL_JOINT,
                       dict(SMALL_PARAMS), None, None, "cpu", run)
    assert bi.wandb_run is run
    rbm = RBM(6, 4, 0.1, 1e-4, 0.5, False, 0.97, False, 0.05, None, 0,
              torch.bfloat16, device="cpu")
    assert rbm.W.dtype == torch.bfloat16
    st = rbm_ops.init_rbm_state(0, 6, 4, torch.bfloat16)
    assert st.w.dtype == torch.bfloat16 and st.w.device.type == "cpu"
    states = [rbm_ops.init_rbm_state(1, 12, 8)]
    data = (torch.rand(16, 12, generator=torch.Generator().manual_seed(0))
            > 0.5).float()
    pos = dbn_train.idbn_epoch(states, 3, data, 0.1, 0.5, 1e-4, 0.05, cd=1,
                               sparsity_flags=(False,), batch_size=8)
    kw = dbn_train.idbn_epoch(states, 3, data, lr=0.1, mom=0.5,
                              weight_decay=1e-4, sparsity_factor=0.05, cd=1,
                              sparsity_flags=(False,), batch_size=8,
                              fast_sampler=False)
    assert all(torch.equal(a, b) for a, b in zip(
        dataclasses.astuple(pos[0][0]) + (pos[1],),
        dataclasses.astuple(kw[0][0]) + (kw[1],)))
    step = dbn_train.idbn_batch_step(states, 3, data[:8], 0.1, 0.5, 1e-4,
                                     0.05, cd=1, sparsity_flags=(False,))
    assert tuple(step[1].shape) == (1,)
    chains = [rbm_ops.init_pcd_chains(2, 8, 12)]
    out = dbn_train.idbn_epoch_pcd(states, chains, 3, data, 0.1, 0.5, 1e-4,
                                   0.05, cd=1, sparsity_flags=(False,),
                                   batch_size=8)
    assert np.isfinite(out[2].numpy()).all()


def test_joint_train_batch_step_has_jax_defaults():
    """``joint_train_batch_step`` without ``zclamp_every`` /
    ``compute_metrics`` is the batch at JAX's 50 and True."""
    from multimodal_idbn_tpu_torch.ops import imdbn_ops, rbm_ops
    Dz, K, B = 6, 3, 4
    g = torch.Generator().manual_seed(0)
    joint = rbm_ops.init_rbm_state(1, Dz + K, 5)
    img = [rbm_ops.init_rbm_state(2, 10, Dz)]
    zb = torch.rand(B, Dz, generator=g)
    yb = torch.eye(K)[torch.arange(B) % K]
    imgb = torch.rand(B, 10, generator=g)
    statics = dict(warmup=False, joint_cd=1, aux_cond_steps=2, Dz=Dz,
                   steps=2, groups=((Dz, Dz + K),))
    args = (joint, img, 7, zb, yb, imgb, 0, 0.1, 0.5, 1e-4, None)
    got = imdbn_ops.joint_train_batch_step(*args, **statics)
    want = imdbn_ops._joint_train_batch(*args, zclamp_every=50,
                                        compute_metrics=True, **statics)
    assert float(got[2].n) == B
    for a, b in zip(dataclasses.astuple(got[0]) + tuple(got[1:2])
                    + tuple(got[2]),
                    dataclasses.astuple(want[0]) + tuple(want[1:2])
                    + tuple(want[2])):
        assert torch.equal(a, b)
