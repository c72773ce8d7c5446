"""Cross-entropy path choice (part of a port of
``dlrover_tpu/ops/fused_ce.py``).

Only the crossover that ``llama.resolve_ce_path`` reads is here: below
``AUTO_FUSED_MIN_NV`` (rows x vocab) the "auto" mode runs the dense
logits path. The fused cross-entropy itself (chunked, XLA and the
hand-written B3/B4 kernels) is the next slice of the port.
"""

# N*V at which "auto" switches from dense logits to the fused CE: 2 GiB
# of f32 logits (the JAX package's measured crossover).
AUTO_FUSED_MIN_NV = 2 * 1024**3 // 4


def auto_prefers_dense(n_tokens: int, vocab: int) -> bool:
    """True when CE "auto" should run the dense logits path for a batch
    of ``n_tokens`` rows over ``vocab`` classes."""
    return n_tokens * vocab < AUTO_FUSED_MIN_NV
