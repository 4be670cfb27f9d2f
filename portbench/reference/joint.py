"""Reference of the iMDBN's joint RBM at serving: the visible layer is
[z ⊕ y], y a softmax group of K labels; the clamped chains (mean-field,
and noisy mean-field annealing with a pull towards the class mean), the
fully sampled clamped chain, the encodes and decodes through the image
stack, and the bias statistics the joint starts from.

Uniforms of the plain code are drawn at stream 2 (``keys.plain_uniform``),
the chain's Gaussian noise at streams 0 (hidden) and 1 (visible) with the
step as the counter's third word."""

from __future__ import annotations

from typing import List, Optional

import torch

from portbench.reference import keys
from portbench.reference.rbm import Arith, State, hidden_probs, \
    visible_probs


def joint_visible(ar: Arith, st: State, h, Dz: int, K: int, inv_T=1.0,
                  noise=None):
    """Visible probabilities of the joint: sigmoid, the label group a
    softmax of its logits."""
    logits = (ar.mm(h, st["w"].T) + st["vb"]) * inv_T
    if noise is not None:
        logits = logits + noise
    p = torch.sigmoid(logits)
    return torch.cat([p[:, :Dz], torch.softmax(logits[:, Dz:Dz + K], -1),
                      p[:, Dz + K:]], dim=1)


def categorical(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One-hot rows drawn by Gumbel-max from the probabilities ``p`` with
    the uniforms ``u``."""
    tiny = torch.finfo(torch.float32).tiny
    idx = torch.argmax(torch.log(torch.clamp(p, 1e-8, 1.0))
                       - torch.log(-torch.log(u.clamp(min=tiny))), -1)
    return torch.nn.functional.one_hot(idx, p.shape[1]).float()


def represent(ar: Arith, layers: List[State], x):
    for st in layers:
        x = hidden_probs(ar, st, x)
    return x


def decode(ar: Arith, layers: List[State], top):
    for st in reversed(layers):
        top = visible_probs(ar, st, top)
    return top


def decode_sampled(ar: Arith, layers: List[State], top, key: int):
    cur = top
    for i, st in enumerate(reversed(layers)):
        cur = visible_probs(ar, st, cur)
        if i < len(layers) - 1:
            u = keys.plain_uniform(keys.fold_in(key, i), cur.shape,
                                   cur.device)
            cur = (cur > u).float()
    return cur


def bias_stats(Z, Y, K: int):
    """(z bias, y bias, per-class mean latents) of the latents Z and the
    one-hot labels Y: logit of the clipped mean latent, log of the
    smoothed label priors, each class's mean latent (the global mean for
    an empty class)."""
    mean_z = torch.clamp(Z.mean(0), 1e-4, 1 - 1e-4)
    counts_y = Y.sum(0)
    priors = counts_y / torch.clamp(counts_y.sum(), min=1.0)
    priors = (priors + 1e-6) / (priors.sum() + 1e-6 * K)
    onehot = torch.nn.functional.one_hot(Y.argmax(1), K).to(Z.dtype)
    sums = onehot.T @ Z
    counts = onehot.sum(0)
    means = torch.where((counts > 0)[:, None],
                        sums / torch.clamp(counts, min=1.0)[:, None],
                        mean_z[None, :])
    return (torch.log(mean_z) - torch.log1p(-mean_z), torch.log(priors),
            means)


def annealed_schedule(n: int, T0: float, T1: float, sigma0: float,
                      sharpen_last: int, T_cold: float, eta0: float):
    """Rows (1/T_t, σ_t, η_t): T linear from T0 to T1, its last
    ``max(1, sharpen_last)`` steps at ``T_cold``; σ and η falling
    linearly to 0."""
    f32 = torch.float32
    t = torch.arange(n, dtype=f32)
    alpha = torch.clamp(t / (n - 1), 0.0, 1.0) if n > 1 else None
    T = (torch.tensor(T0, dtype=f32) + (torch.tensor(T1, dtype=f32) - T0)
         * alpha) if n > 1 else torch.full_like(t, float(T1))
    T = torch.where((n - t) <= max(1, int(sharpen_last)),
                    torch.tensor(T_cold, dtype=f32), T)
    fall = torch.clamp(1.0 - t / max(1, n - 1), min=0.0)
    return torch.stack([1.0 / torch.clamp(T, min=1e-6),
                        torch.tensor(sigma0, dtype=f32) * fall,
                        torch.tensor(eta0, dtype=f32) * fall], dim=1)


def chain_init(key: int, v_known, km):
    u = keys.plain_uniform(key, v_known.shape, v_known.device)
    return v_known * km + (1.0 - km) * u


def clamped_chain(ar: Arith, st: State, v, v_known, km, sched, Dz: int,
                  K: int, *, mu=None, seed: Optional[int] = None,
                  final_unclamped: bool = False):
    """The clamped mean-field chain: per step h from v and v from h at
    1/T_t with σ_t noise on both logits, the pull by η_t towards ``mu``
    on the first columns, the known coordinates re-clamped; then, with
    ``final_unclamped``, one plain pass with none of these."""
    B, V = v.shape
    H = st["w"].shape[1]
    T = sched.shape[0]
    if seed is not None:
        noise_h = keys.normal_steps(seed, B, H, T, stream=keys.STREAM_KERNEL,
                                     device=v.device)
        noise_v = keys.normal_steps(seed, B, V, T, stream=keys.STREAM_CHAIN_V,
                                     device=v.device)
    for t in range(T):
        inv_T, sig, eta = (float(x) for x in sched[t])
        hl = (ar.mm(v, st["w"]) + st["hb"]) * inv_T
        nv = None
        if seed is not None:
            hl = hl + noise_h[t] * sig
            nv = noise_v[t] * sig
        h = torch.sigmoid(hl)
        p = joint_visible(ar, st, h, Dz, K, inv_T, nv)
        if mu is not None:
            dz = mu.shape[1]
            p = torch.cat([(1.0 - eta) * p[:, :dz] + eta * mu, p[:, dz:]],
                          dim=1)
        v = p * (1.0 - km) + v_known * km
    if final_unclamped:
        v = joint_visible(ar, st, hidden_probs(ar, st, v), Dz, K)
    return v


def img2txt(ar, image_layers, joint, images, key: int, *, Dz, K, steps):
    """p(y | image): z clamped, the labels by the mean-field chain."""
    return z2txt(ar, joint, represent(ar, image_layers, images), key,
                 Dz=Dz, K=K, steps=steps)


def z2txt(ar, joint, z, key: int, *, Dz, K, steps):
    """p(y | z): the img2txt half from the image latents."""
    B = z.shape[0]
    dev = z.device
    v_known = torch.cat([z, torch.zeros((B, K), device=dev)], 1)
    km = torch.cat([torch.ones((B, Dz), device=dev),
                    torch.zeros((B, K), device=dev)], 1)
    k = keys.fold_in(key, 0)
    v = chain_init(keys.fold_in(k, 0), v_known, km)
    sched = torch.tensor([[1.0, 0.0, 0.0]]).repeat(steps, 1)
    return clamped_chain(ar, joint, v, v_known, km, sched, Dz, K,
                         final_unclamped=True)[:, Dz:]


def txt2img(ar, image_layers, joint, y, z_class_mean, key: int, *, Dz, K,
            steps):
    """Image from labels: y clamped, noisy annealing pulled to the class
    mean latent, decoded through the image stack."""
    B = y.shape[0]
    dev = y.device
    v_known = torch.cat([torch.zeros((B, Dz), device=dev), y], 1)
    km = torch.cat([torch.zeros((B, Dz), device=dev),
                    torch.ones((B, K), device=dev)], 1)
    k = keys.fold_in(key, 1)
    v = chain_init(keys.fold_in(k, 0), v_known, km)
    sched = annealed_schedule(steps, 3.0, 1.0, 0.9, 3, 0.9, 0.15)
    v = clamped_chain(ar, joint, v, v_known, km, sched, Dz, K,
                      mu=z_class_mean[y.argmax(1)],
                      seed=keys.fold_in(k, 1))
    return decode(ar, image_layers, v[:, :Dz])


def sample_txt2img(ar, image_layers, joint, y, key: int, *, Dz, K, steps):
    """Image drawn from p(image | y): the fully sampled clamped chain
    (h Bernoulli, v Bernoulli with the label group categorical), then the
    ancestral-sampled decode."""
    B = y.shape[0]
    dev = y.device
    v_known = torch.cat([torch.zeros((B, Dz), device=dev), y], 1)
    km = torch.cat([torch.zeros(Dz, device=dev), torch.ones(K, device=dev)])
    k0 = keys.fold_in(key, 0)
    v = chain_init(keys.fold_in(k0, 0), v_known, km)
    kloop = keys.fold_in(k0, 1)
    kts = [keys.fold_in(kloop, t) for t in range(steps)]
    kvs = [keys.fold_in(kt, 1) for kt in kts]
    H, V = joint["w"].shape[1], v.shape[1]
    st2 = keys.STREAM_UNIFORM
    uh = keys.uniform_stack([keys.fold_in(kt, 0) for kt in kts], B, H,
                            stream=st2, device=dev)
    uv = keys.uniform_stack(kvs, B, V, stream=st2, device=dev)
    ug = keys.uniform_stack([keys.fold_in(kv, 1) for kv in kvs], B, K,
                            stream=st2, device=dev)
    for t in range(steps):
        h = (hidden_probs(ar, joint, v) > uh[t]).float()
        p = joint_visible(ar, joint, h, Dz, K)
        s = (p > uv[t]).float()
        s[:, Dz:Dz + K] = categorical(p[:, Dz:Dz + K], ug[t])
        v = s * (1.0 - km) + v_known * km
    return decode_sampled(ar, image_layers, v[:, :Dz], keys.fold_in(key, 1))


def next_keys(seed: int, n: int) -> List[int]:
    """The first ``n`` keys of an RBM's key stream restarted at ``seed``:
    each two 32-bit words drawn by a CPU generator, high word second."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    out = []
    for _ in range(n):
        lo, hi = torch.randint(0, 1 << 32, (2,), generator=gen,
                               dtype=torch.int64).tolist()
        out.append((hi << 32) | lo)
    return out
