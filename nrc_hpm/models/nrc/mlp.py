"""The NRC MLP: a small bias-free fully-connected network.

Mirrors the reference's tcnn FullyFusedMLP configuration
(src/NeuralRadianceCache.cu:30-36): ReLU hidden activations, no output
activation, ``n_neurons`` wide, ``n_hidden_layers`` hidden matmuls, and —
like tcnn's fully fused kernels — NO bias terms.  Matmuls run in the
configured compute dtype (bf16 by default) with float32 accumulation;
parameters are stored float32.

This module serves both training and inference (cache.infer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def init_mlp(key: jax.Array, in_dim: int, width: int, depth: int,
             out_dim: int = 3) -> dict:
    """He-uniform init; ``depth`` counts hidden matmuls like tcnn's
    n_hidden_layers (total layers = depth + 1 with the output projection)."""
    dims = [in_dim] + [width] * depth + [out_dim]
    keys = jax.random.split(key, len(dims) - 1)
    layers = []
    for k, (a, b) in zip(keys, zip(dims[:-1], dims[1:])):
        bound = jnp.sqrt(6.0 / a)
        layers.append(jax.random.uniform(k, (a, b), jnp.float32,
                                         minval=-bound, maxval=bound))
    return {"layers": layers}


def mlp_apply(params: dict, x: jax.Array,
              compute_dtype=jnp.bfloat16) -> jax.Array:
    """Forward pass: x (..., in_dim) -> (..., out_dim) float32."""
    h = x.astype(compute_dtype)
    layers = params["layers"]
    for i, w in enumerate(layers):
        h = jnp.dot(h, w.astype(compute_dtype),
                    preferred_element_type=jnp.float32)
        if i + 1 < len(layers):
            h = jnp.maximum(h, 0.0).astype(compute_dtype)
    return h.astype(jnp.float32)
