"""RBM object shell over the port's functional core.

Port of multimodal_idbn_tpu/models/rbm.py:163-486 with the same public
names: the attribute surface (``W``, ``hid_bias``, ``vis_bias``, ``W_m``,
``hb_m``, ``vb_m``), the conditionals and samplers (:282-341), training
(``train_epoch``, ``train_epoch_clamped``, :355-388), conditional
inference (:392-466) and pickling (:470-481). The shell owns an
``RBMState``, an explicit ``torch.Generator`` (its key stream,
``ops.rng.next_key``) and its device. It pickles as numpy arrays plus the
generator's state, never as device tensors, and unpickles onto the CPU in
fp32, as the JAX shell unpickles (:483-487); ``to(device)`` moves it.

Also ported: the global seeding of shells built without a seed
(``_GLOBAL_SEED``, the instance counter and ``set_global_seed``, :29-46)
and the parsing of the precision keys of a params dict (``param_dtype``,
``param_compute_dtype``, ``param_sr``, ``_warn_compute_dtype_joint``,
:49-120), mapped to torch dtypes. A shell takes ``dtype=`` (its storage
dtype) and ``sr=`` (the stochastic-rounding override).

The JAX shell calls each of its entries through a jitted function
(models/rbm.py:136-157). Here each entry is one replay of a CUDA graph on
the card, one graph per entry and signature (``ops.graphs``: the shell's
cache, ``self._serving``, dropped from pickles): ``forward``,
``visible_probs``, ``backward``, ``sample_visible``, ``backward_sample``,
``gibbs_step``, ``free_energy`` and the conditional chains read the
weights; ``train_epoch`` and ``train_epoch_clamped`` update the state in
place (``graphs.update``), their learning rate and momentum read from a
device tensor (``graphs.hyper``). The key stream advances as launch by
launch: one key drawn on the host per drawing call. On the CPU every
entry runs launch by launch.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from multimodal_idbn_tpu_torch import convert
from multimodal_idbn_tpu_torch.device import (DeviceLike, as_tensor,
                                              resolve_device)
from multimodal_idbn_tpu_torch.ops import (fast_cd, graphs, rbm_ops, rng,
                                           sampling)
from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState
from multimodal_idbn_tpu_torch.ops.schedules import (effective_lr,
                                                     effective_momentum)

# ---------------------------------------------------------------------------
# Global seeding (JAX models/rbm.py:29-46)
# ---------------------------------------------------------------------------

_GLOBAL_SEED = 0
_instance_counter = itertools.count()


def set_global_seed(seed: int) -> None:
    """Set the base seed of shells constructed without an explicit seed."""
    global _GLOBAL_SEED
    _GLOBAL_SEED = int(seed)


def _fresh_seed(seed: Optional[int]) -> int:
    """``seed``, or ``_GLOBAL_SEED + next(counter)`` for an unseeded shell,
    so that no two unseeded shells share weights or a key stream."""
    if seed is None:
        seed = _GLOBAL_SEED + next(_instance_counter)
    return int(seed)


# ---------------------------------------------------------------------------
# Precision keys of a params dict (JAX models/rbm.py:49-120)
# ---------------------------------------------------------------------------

def param_dtype(params: dict) -> torch.dtype:
    """Storage dtype from a params dict: ``DTYPE`` in {"float32",
    "bfloat16"} (default float32, the reference's)."""
    name = str((params or {}).get("DTYPE", "float32")).lower()
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32", "fp32"):
        return torch.float32
    raise ValueError(f"unsupported DTYPE {name!r} (float32 | bfloat16)")


def param_compute_dtype(params: dict) -> Optional[torch.dtype]:
    """Mixed-precision compute dtype from a params dict: ``COMPUTE_DTYPE``
    in {None/"float32", "bfloat16"}. bf16 runs the Gibbs chain of the
    fp32 master weights on a bf16 copy (``rbm_ops.compute_cast``); None is
    the reference's fp32 path."""
    name = (params or {}).get("COMPUTE_DTYPE", None)
    if name is None:
        return None
    name = str(name).lower()
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32", "fp32", "none"):
        return None
    raise ValueError(
        f"unsupported COMPUTE_DTYPE {name!r} (float32 | bfloat16)")


def param_sr(params: dict) -> Optional[bool]:
    """Stochastic-rounding override from a params dict: ``SR`` in
    {None/"auto", True, False} (YAML ``training.stochastic_rounding``).
    None keeps the auto rule (on exactly for bf16 storage), False forces
    the nearest-rounded epilogue, True forces rounding on."""
    val = (params or {}).get("SR", None)
    if val is None or (isinstance(val, str)
                       and val.lower() in ("auto", "none", "")):
        return None
    if isinstance(val, bool):
        return val
    if isinstance(val, str):
        if val.lower() in ("true", "on", "1", "yes"):
            return True
        if val.lower() in ("false", "off", "0", "no"):
            return False
    raise ValueError(f"unsupported SR {val!r} (auto | true | false)")


def _dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name JAX prints for a dtype ("float32",
    "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _warn_compute_dtype_joint(params: dict, family: str) -> None:
    """The line printed at multimodal construction when ``COMPUTE_DTYPE``
    is set: mixed precision applies to the modality iDBN stacks only, the
    joint layers train at the storage dtype."""
    if param_compute_dtype(params) is not None:
        print(f"[{family}] warn/compute_dtype_joint: COMPUTE_DTYPE "
              f"applies to the modality iDBN stacks only; the joint "
              f"layers train at the storage dtype "
              f"({_dtype_name(param_dtype(params))}).")


# ---------------------------------------------------------------------------
# The shell's calls as ``ops.graphs`` replays them: weights first, the key
# by keyword, schedule values from ``graphs.hyper``
# ---------------------------------------------------------------------------

def _sample_visible(v_prob, *, key, groups):
    return sampling.sample_visible(key, v_prob, groups)


def _backward_sample(weights, h, *, key, groups):
    return sampling.sample_visible(
        key, rbm_ops.visible_probs(weights, h, groups=groups), groups)


def _gibbs_step(weights, v, *, key, **kw):
    return rbm_ops.gibbs_step(weights, key, v, **kw)


def _cd_update(state, data, hyper, *, key, **kw):
    """(new state, loss) of ``fast_cd.cd_update`` at ``hyper`` = (lr,
    mom)."""
    return fast_cd.cd_update(state, key, data, lr=hyper[0], mom=hyper[1],
                             **kw)


def _clamped_cd_update(state, v_known, known_mask, hyper, mu_k, *, key,
                       **kw):
    return rbm_ops.clamped_cd_update(state, key, v_known, known_mask,
                                     lr=hyper[0], mom=hyper[1], mu_k=mu_k,
                                     **kw)


def _conditional(chain):
    """A conditional chain of ``rbm_ops`` with its key by keyword."""
    def call(weights, v_known, known_mask, *, key, **kw):
        return chain(weights, key, v_known, known_mask, **kw)

    call.__name__ = chain.__name__
    return call


_conditional_gibbs = _conditional(rbm_ops.conditional_gibbs)
_conditional_gibbs_annealed = _conditional(
    rbm_ops.conditional_gibbs_annealed)
_noisy_meanfield_annealed = _conditional(rbm_ops.noisy_meanfield_annealed)


class RBM:
    """Restricted Boltzmann Machine with Bernoulli units and softmax groups
    (reference rbm.py:24; JAX models/rbm.py:163-211).

    ``seed`` seeds this instance's generator and initial weights (an
    unseeded shell takes ``_GLOBAL_SEED`` plus its instance number);
    ``device`` is ``cuda`` unless ``"cpu"`` is asked for; ``dtype`` is the
    storage dtype of every state field (fp32 unless bf16 is asked for);
    ``sr`` overrides the stochastic-rounding rule of its updates.
    """

    def __init__(self, num_visible: int, num_hidden: int,
                 learning_rate: float, weight_decay: float, momentum: float,
                 dynamic_lr: bool = False, final_momentum: float = 0.97,
                 sparsity: bool = False, sparsity_factor: float = 0.05,
                 softmax_groups: Optional[List[Tuple[int, int]]] = None,
                 seed: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 sr: Optional[bool] = None, device: DeviceLike = None):
        self.num_visible = int(num_visible)
        self.num_hidden = int(num_hidden)
        self.lr = float(learning_rate)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.dynamic_lr = bool(dynamic_lr)
        self.final_momentum = float(final_momentum)
        self.sparsity = bool(sparsity)
        self.sparsity_factor = float(sparsity_factor)
        self.softmax_groups = [tuple(g) for g in (softmax_groups or [])]
        self.sr = sr
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(_fresh_seed(seed))
        self.state = rbm_ops.init_rbm_state(
            self._next_key(), self.num_visible, self.num_hidden,
            device=self.device, dtype=dtype or torch.float32)
        # μ-pull side channel of the reference API (rbm.py:359).
        self._mu_pull = None

    def _groups(self):
        return tuple(tuple(g) for g in self.softmax_groups)

    def _next_key(self) -> int:
        return rng.next_key(self._gen)

    def _as(self, x) -> torch.Tensor:
        return as_tensor(x, self.device)

    def _as_stored(self, x) -> torch.Tensor:
        return self._as(x).to(self.state.w.dtype)

    # Reference attribute surface (JAX models/rbm.py:233-287); values set
    # take the storage dtype.
    @property
    def W(self) -> torch.Tensor:
        return self.state.w

    @W.setter
    def W(self, value) -> None:
        self.state = self.state.replace(w=self._as_stored(value))

    @property
    def hid_bias(self) -> torch.Tensor:
        return self.state.hb

    @hid_bias.setter
    def hid_bias(self, value) -> None:
        self.state = self.state.replace(
            hb=self._as_stored(value).reshape(-1))

    @property
    def vis_bias(self) -> torch.Tensor:
        return self.state.vb

    @vis_bias.setter
    def vis_bias(self, value) -> None:
        self.state = self.state.replace(
            vb=self._as_stored(value).reshape(-1))

    @property
    def W_m(self) -> torch.Tensor:
        return self.state.w_m

    @W_m.setter
    def W_m(self, value) -> None:
        self.state = self.state.replace(w_m=self._as_stored(value))

    @property
    def hb_m(self) -> torch.Tensor:
        return self.state.hb_m

    @hb_m.setter
    def hb_m(self, value) -> None:
        self.state = self.state.replace(
            hb_m=self._as_stored(value).reshape(-1))

    @property
    def vb_m(self) -> torch.Tensor:
        return self.state.vb_m

    @vb_m.setter
    def vb_m(self, value) -> None:
        self.state = self.state.replace(
            vb_m=self._as_stored(value).reshape(-1))

    def reset_momentum(self) -> None:
        """Zero the momentum buffers, as the reference does on load
        (JAX models/rbm.py:282-287)."""
        st = self.state
        self.state = st.replace(w_m=torch.zeros_like(st.w),
                                hb_m=torch.zeros_like(st.hb),
                                vb_m=torch.zeros_like(st.vb))

    def reseed(self, seed: int) -> None:
        """Restart this instance's key stream from ``seed``, so that the
        next inference call draws what a fresh ``seed`` draws."""
        self._gen.manual_seed(int(seed))

    def to(self, device: DeviceLike = None) -> "RBM":
        """Move the parameters to ``device`` (``cuda`` unless ``"cpu"`` is
        asked for) and return ``self``. The JAX shell's ``to`` is a no-op
        (models/rbm.py:289-292); here a model loaded from a pickle lies on
        the CPU until it is moved."""
        self.device = resolve_device(device)
        self.state = RBMState(*(getattr(self.state, f).to(self.device)
                                for f in convert.FIELDS))
        return self

    # -- conditionals -----------------------------------------------------

    def _serve(self, fn, key, *args, **kwargs):
        """``fn`` on the shell's weights (one replay on the card)."""
        return graphs.serve(self, self.device, fn, key,
                            rbm_ops.weights_only(self.state), *args,
                            **kwargs)

    def forward(self, v, T: float = 1.0) -> torch.Tensor:
        """p(h|v) with temperature (JAX models/rbm.py:296-298)."""
        return self._serve(rbm_ops.hidden_probs, None, self._as(v), T)

    __call__ = forward

    def visible_probs(self, h, T: float = 1.0) -> torch.Tensor:
        """p(v|h) with softmax groups (JAX models/rbm.py:306-309)."""
        return self._serve(rbm_ops.visible_probs, None, self._as(h), T,
                           groups=self._groups())

    def sample_visible(self, v_prob) -> torch.Tensor:
        """Sample v ~ p(v|h) respecting softmax groups
        (JAX models/rbm.py:311-314)."""
        return graphs.serve(self, self.device, _sample_visible,
                            self._next_key(), self._as(v_prob),
                            groups=self._groups())

    def backward(self, h, return_logits: bool = False) -> torch.Tensor:
        """p(v|h) with softmax groups, or its logits
        (JAX models/rbm.py:316-320)."""
        if return_logits:
            return self._serve(rbm_ops.visible_logits, None, self._as(h))
        return self.visible_probs(h)

    def backward_sample(self, h) -> torch.Tensor:
        """A sample of p(v|h) (one call: the probabilities and the draw)."""
        return self._serve(_backward_sample, self._next_key(), self._as(h),
                           groups=self._groups())

    def gibbs_step(self, v, sample_h: bool = True, sample_v: bool = True):
        """One v→h→v' step; returns (v_next, v_prob, h, h_prob)
        (JAX models/rbm.py:325-330)."""
        return self._serve(_gibbs_step, self._next_key(), self._as(v),
                           sample_h=sample_h, sample_v=sample_v,
                           groups=self._groups())

    def free_energy(self, v) -> torch.Tensor:
        """F(v) = −v·b_v − Σ softplus(b_h + vW) (JAX models/rbm.py:332-340)."""
        return self._serve(rbm_ops.free_energy, None, self._as(v))

    # -- training ---------------------------------------------------------

    def _hyper(self, epoch: int):
        """(lr, momentum) of ``epoch`` for a replayed update."""
        return graphs.hyper(
            self.device, effective_lr(self.lr, epoch, self.dynamic_lr),
            effective_momentum(self.momentum, self.final_momentum, epoch))

    def train_epoch(self, data, epoch: int, max_epochs: int,
                    CD: int = 1) -> torch.Tensor:
        """One CD-k update on a batch; returns the reconstruction MSE
        (JAX models/rbm.py:355-365). Groupless fp32 RBMs train through the
        fused half-step kernel (``ops.fast_cd``); a softmax group or bf16
        storage takes ``rbm_ops.cd_update``, chosen before the call."""
        del max_epochs
        self.state, loss = graphs.update(
            self, self.device, _cd_update, self._next_key(), self.state,
            self._as(data), self._hyper(epoch), groups=self._groups(),
            sr=self.sr, weight_decay=self.weight_decay, cd=int(CD),
            sparsity=self.sparsity, sparsity_factor=self.sparsity_factor)
        return loss

    def train_epoch_clamped(self, v_known, known_mask, epoch: int,
                            max_epochs: int, CD: int = 1,
                            cond_init_steps: int = 50, sample_h: bool = True,
                            sample_v: bool = False,
                            reclamp_negative: bool = True,
                            aux_lr_mult: float = 0.3,
                            use_noisy_init: bool = True) -> torch.Tensor:
        """Auxiliary clamped-CD update with the μ-pull of ``self._mu_pull``
        (JAX models/rbm.py:367-388)."""
        del max_epochs
        mu_k, eta0 = self._mu_pull_args()
        self.state, loss = graphs.update(
            self, self.device, _clamped_cd_update, self._next_key(),
            self.state, self._as(v_known), self._as(known_mask),
            self._hyper(epoch), mu_k, weight_decay=self.weight_decay,
            cd=int(CD), cond_init_steps=int(cond_init_steps),
            sample_h=sample_h, sample_v=sample_v,
            reclamp_negative=reclamp_negative, aux_lr_mult=aux_lr_mult,
            use_noisy_init=use_noisy_init, eta0=eta0, groups=self._groups(),
            sr=self.sr)
        return loss

    # -- conditional inference ---------------------------------------------

    def _mu_pull_args(self):
        """(mu_k, eta0) of the μ-pull side channel (rbm.py:359-363)."""
        mu = self._mu_pull
        if mu is None:
            return None, 0.15
        return self._as(mu["mu_k"]), float(mu.get("eta0", 0.15))

    def conditional_gibbs(self, v_known, known_mask, n_steps: int = 30,
                          sample_h: bool = False,
                          sample_v: bool = False) -> torch.Tensor:
        """Conditional Gibbs chain (JAX models/rbm.py:392-413); the
        mean-field case runs the chain kernel on the card."""
        return self._serve(
            _conditional_gibbs, self._next_key(), self._as(v_known),
            self._as(known_mask), n_steps=int(n_steps), sample_h=sample_h,
            sample_v=sample_v, groups=self._groups())

    def conditional_gibbs_annealed(self, v_known, known_mask,
                                   n_steps: int = 40, T0: float = 2.5,
                                   T1: float = 1.0, sample_h_until: int = 20,
                                   sample_v_every: int = 0,
                                   final_meanfield: bool = True
                                   ) -> torch.Tensor:
        """Annealed conditional Gibbs (JAX models/rbm.py:423-434)."""
        return self._serve(
            _conditional_gibbs_annealed, self._next_key(),
            self._as(v_known), self._as(known_mask), n_steps=int(n_steps),
            T0=T0, T1=T1, sample_h_until=int(sample_h_until),
            sample_v_every=int(sample_v_every),
            final_meanfield=final_meanfield, groups=self._groups())

    def noisy_meanfield_annealed(self, v_known, known_mask,
                                 n_steps: int = 72, T0: float = 3.0,
                                 T1: float = 1.0, sigma0: float = 0.9,
                                 hot_frac: float = 0.7,
                                 sharpen_last: int = 3,
                                 T_cold_plus: float = 0.9) -> torch.Tensor:
        """Noisy mean-field annealing with μ-pull read from
        ``self._mu_pull`` ({"mu_k": [B,Dz], "eta0": η}), as the reference
        API (JAX models/rbm.py:436-466)."""
        mu_k, eta0 = self._mu_pull_args()
        return self._serve(
            _noisy_meanfield_annealed, self._next_key(), self._as(v_known),
            self._as(known_mask), n_steps=int(n_steps), T0=T0, T1=T1,
            sigma0=float(sigma0), hot_frac=float(hot_frac),
            sharpen_last=int(sharpen_last), T_cold_plus=T_cold_plus,
            mu_k=mu_k, eta0=eta0, groups=self._groups())

    # -- pickling (JAX models/rbm.py:470-481) --------------------------------

    def __getstate__(self):
        """fp32 numpy arrays (a bf16 state widened exactly) and the
        generator's state: a payload written on the card loads on a
        machine without one."""
        d = dict(self.__dict__)
        d["state"] = tuple(getattr(self.state, f).detach().float().cpu()
                           .numpy() for f in convert.FIELDS)
        d["_gen"] = self._gen.get_state().numpy()
        d["device"] = "cpu"
        d["_mu_pull"] = None
        d.pop("_serving", None)  # graphs live with their process
        return d

    def __setstate__(self, d):
        d.setdefault("sr", None)  # pickles written before the variants
        self.__dict__.update(d)
        self.state = RBMState(*(
            torch.from_numpy(np.array(a, np.float32)) for a in d["state"]))
        self._gen = torch.Generator()
        self._gen.set_state(torch.from_numpy(np.array(d["_gen"], np.uint8)))
        self.device = torch.device("cpu")

    def __repr__(self):
        return (f"RBM(num_visible={self.num_visible}, "
                f"num_hidden={self.num_hidden}, "
                f"softmax_groups={self.softmax_groups}, "
                f"device={self.device})")
