"""NeuralRadianceCache: encoding + MLP + online training state.

Rebuild of src/NeuralRadianceCache.cu: the tcnn TrainableModel
(loss/optimizer/encoding/network JSON, :16-38) becomes an explicit pytree
state with optax Adam wrapped in parameter EMA — the reference's
``{"otype": "EMA", "nested": {"otype": "Adam"}}`` optimizer — and the
losses are reimplemented with tcnn semantics (denominators detached).

Training consumes ``train_batch_count`` batches of ``2^log2_train_batch``
samples per frame (NeuralRadianceCache.cu:147-156); inference runs over the
(filtered) infer buffer using the EMA parameters.  Gradients flow through
the MLP and the hash grid exactly as tcnn's backward does; targets are MC
estimates (stop-gradient by construction).

For multi-chip training, ``train_step`` accepts a mesh axis name and
``psum``s gradients over it (new capability; the reference is single-GPU).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import optax

from ...config import AppConfig
from ...utils import pytree
from .encoding import CompositeEncoding
from .mlp import init_mlp, mlp_apply


def luminance(rgb: jax.Array) -> jax.Array:
    """tcnn relative-L2-luminance coefficients (0.299, 0.587, 0.114)."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])


def make_loss_fn_per_sample(name: str):
    """tcnn loss zoo subset, PER-SAMPLE (mean over channels -> (B,));
    denominators are detached like tcnn's backward
    (gradient = 2(pred-target)/denom)."""
    name = name.lower()

    def rel_l2_luminance(pred, target):
        lum = jax.lax.stop_gradient(luminance(pred))
        denom = lum * lum + 0.01
        return jnp.mean((pred - target) ** 2 / denom[..., None], axis=-1)

    def rel_l2(pred, target):
        denom = jax.lax.stop_gradient(pred) ** 2 + 0.01
        return jnp.mean((pred - target) ** 2 / denom, axis=-1)

    def l2(pred, target):
        return jnp.mean((pred - target) ** 2, axis=-1)

    def l1(pred, target):
        return jnp.mean(jnp.abs(pred - target), axis=-1)

    table = {"relativel2luminance": rel_l2_luminance,
             "relativel2": rel_l2, "l2": l2, "l1": l1}
    if name not in table:
        raise ValueError(f"unsupported loss {name!r}; "
                         f"choose from {sorted(table)}")
    return table[name]


def make_loss_fn(name: str):
    """Batch-mean form of make_loss_fn_per_sample (the tcnn loss value)."""
    per = make_loss_fn_per_sample(name)

    def mean_loss(pred, target):
        return jnp.mean(per(pred, target))

    return mean_loss


def make_optimizer(name: str, lr: float) -> optax.GradientTransformation:
    """Nested optimizer of the EMA wrapper (NeuralRadianceCache.cu:20-28).
    tcnn Adam defaults: beta1 0.9, beta2 0.999, eps 1e-8."""
    name = name.lower()
    if name == "adam":
        return optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    if name == "sgd":
        return optax.sgd(lr)
    raise ValueError(f"unsupported optimizer {name!r}")


@pytree.dataclass
class NrcState:
    """Trainable cache state (a pure pytree: donate/shard at will)."""

    params: dict          # {"encoding": {...}, "mlp": {...}}
    ema_params: dict      # EMA copy used for inference
    opt_state: object
    loss: jax.Array       # () last training-batch loss (m_Loss analog)
    step: jax.Array       # () int32


class NeuralRadianceCache:
    """Facade bundling encoding, MLP, loss and optimizer for an AppConfig.

    Static (Python-side) object; all numeric state lives in NrcState.
    """

    N_INPUT = 5   # posX, posY, posZ, theta, phi (NeuralRadianceCache.cu:8)
    N_OUTPUT = 3  # r, g, b (NeuralRadianceCache.cu:9)

    def __init__(self, cfg: AppConfig):
        self.cfg = cfg
        self.encoding = CompositeEncoding(cfg.encoding)
        self.width = cfg.nn_width
        self.depth = cfg.nn_depth
        self.loss_fn = make_loss_fn(cfg.loss_fn)
        self.loss_fn_per_sample = make_loss_fn_per_sample(cfg.loss_fn)
        self.optimizer = make_optimizer(cfg.optimizer, cfg.learning_rate)
        self.ema_decay = cfg.ema_decay
        self.compute_dtype = jnp.bfloat16 if cfg.mlp_dtype == "bfloat16" \
            else jnp.float32
        # bf16 packed-gather forward + matmul-scatter backward for the
        # hash grid (level tables <= 2^16 only; see encoding.py)
        self.train_fast = getattr(cfg, "hash_train_fast", True)

    def init_state(self, key: jax.Array) -> NrcState:
        k_enc, k_mlp = jax.random.split(key)
        params = {
            "encoding": self.encoding.init_params(k_enc),
            "mlp": init_mlp(k_mlp, self.encoding.out_dim, self.width,
                            self.depth, self.N_OUTPUT),
        }
        return NrcState(
            params=params,
            # a REAL copy: aliasing params would break buffer donation
            ema_params=jax.tree.map(jnp.copy, params),
            opt_state=self.optimizer.init(params),
            loss=jnp.float32(0.0),
            step=jnp.int32(0))

    # -- forward ------------------------------------------------------------
    def apply(self, params: dict, x5: jax.Array, packed=None,
              train_fast: bool = False) -> jax.Array:
        feats = self.encoding(params["encoding"], x5, packed=packed,
                              train_fast=train_fast)
        return mlp_apply(params["mlp"], feats, self.compute_dtype)

    def infer(self, state: NrcState, x5: jax.Array) -> jax.Array:
        """Batched inference with the EMA parameters (tcnn EMA optimizer
        serves smoothed weights for inference).  The hash table is packed
        to bf16 pairs on the fly — one gathered word per corner — matching
        tcnn's half-precision inference parameters.  XLA fuses the
        encode and the MLP; a hand-written fused kernel measured no faster
        end to end on the GPU (PERF.md)."""
        packed = self.encoding.pack_params(state.ema_params["encoding"])
        return self.apply(state.ema_params, x5, packed=packed or None)

    # -- training -----------------------------------------------------------
    def train_step(self, state: NrcState, x5: jax.Array, target: jax.Array,
                   axis_name: Optional[str] = None,
                   weight: Optional[jax.Array] = None) -> NrcState:
        """One optimizer step on one (batch, 5)/(batch, 3) training batch.
        With ``axis_name`` set, gradients are psum-averaged over the mesh
        axis (replicated-parameter data parallelism).  ``weight``
        (B,) masks padding lanes on uneven shards: the weighted global
        gradient (psum of weighted sums / psum of weights) equals the
        single-chip gradient over only the weight>0 samples."""

        if weight is None:
            def loss_of(params):
                pred = self.apply(params, x5, train_fast=self.train_fast)
                return self.loss_fn(pred, target)
        else:
            tot = jnp.sum(weight)
            if axis_name is not None:
                tot = jax.lax.psum(tot, axis_name)
            inv_tot = 1.0 / jnp.maximum(tot, 1.0)

            def loss_of(params):
                pred = self.apply(params, x5, train_fast=self.train_fast)
                per = self.loss_fn_per_sample(pred, target)
                return jnp.sum(per * weight) * inv_tot

        loss, grads = jax.value_and_grad(loss_of)(state.params)
        if axis_name is not None:
            if weight is None:
                grads = jax.lax.pmean(grads, axis_name)
                loss = jax.lax.pmean(loss, axis_name)
            else:
                grads = jax.lax.psum(grads, axis_name)
                loss = jax.lax.psum(loss, axis_name)
        updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                                   state.params)
        params = optax.apply_updates(state.params, updates)
        # tcnn's EMA optimizer DEBIASES (ema.h: ema_debias_old/new): the
        # served weights are a proper weighted average of trained params
        # only — without this, early inference is dragged toward the random
        # init (at step 60 with decay 0.99 the init still carries ~55%).
        d = self.ema_decay
        t = state.step.astype(jnp.float32)
        debias_old = 1.0 - jnp.power(d, t)
        debias_new = 1.0 / (1.0 - jnp.power(d, t + 1.0))
        ema = jax.tree.map(
            lambda e, p: (e * d * debias_old + p * (1.0 - d)) * debias_new,
            state.ema_params, params)
        return NrcState(params=params, ema_params=ema, opt_state=opt_state,
                        loss=loss, step=state.step + 1)

    def train_frame(self, state: NrcState, x5: jax.Array, target: jax.Array,
                    axis_name: Optional[str] = None,
                    weight: Optional[jax.Array] = None) -> NrcState:
        """The per-frame training pass: ``train_batch_count`` sequential
        steps over equal slices of the frame's training set
        (NeuralRadianceCache.cu:147-156)."""
        n = self.cfg.train_batch_count
        bs = x5.shape[0] // n
        for i in range(n):
            sl = slice(i * bs, (i + 1) * bs)
            state = self.train_step(state, x5[sl], target[sl], axis_name,
                                    None if weight is None else weight[sl])
        return state
