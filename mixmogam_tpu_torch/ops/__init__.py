"""Device compute ops (PyTorch + hand-written Hopper kernels).

Importing this package pins float32 matmuls to true fp32 — the twin of
the JAX package's ``jax_default_matmul_precision='highest'`` pin
(mixmogam_tpu/ops/__init__.py). A TF32 GEMM keeps a 10-bit mantissa and
would silently turn the exact scan tier into a ~1e-3-grade tier.
Importing builds and loads no kernel: that happens at first CUDA use
(ops._build). resolve_device is the entry points' device rule: the card
unless the caller asks for the CPU. The JAX package's ops exports
(eigen_k, projected_spectrum, reml_from_spectrum, NullModel,
fit_null_model, h2_profile_ci, emmax_scan_stats, RotatedNull,
build_rotated_null) load from their modules at first use.
"""

import torch


def _pin_matmul_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the bf16 tiers' library products (ops/rotate.py) sum in float32:
    # cuBLAS may not split their reduction into bf16 partial sums
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("could not pin float32 matmuls to full fp32; "
                           "the exact tier would run in TF32")


_pin_matmul_precision()


def assert_fp32_matmuls() -> None:
    """Raise if something re-enabled TF32 or cuBLAS's reduced-precision
    bf16 reduction after import (called before the float32 rotation GEMMs
    and the bf16 parts' products)."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls were re-enabled (torch.backends.cuda.matmul."
            "allow_tf32 / set_float32_matmul_precision); the exact tier "
            "needs full fp32 GEMMs")
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_bf16_reduced_precision_"
            "reduction was re-enabled; the bf16 tiers' products need "
            "float32 sums")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the card.
    Without a card it raises; nothing runs on the CPU unless asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False) and this call runs on the card by default; pass "
            'device="cpu" to run it on the CPU')
    return torch.device("cuda")


#: the JAX package's ops exports (mixmogam_tpu/ops/__init__.py), loaded at
#: first use: the modules behind them import this package for
#: resolve_device
_EXPORTS = {"eigen_k": "eigen", "projected_spectrum": "eigen",
            "reml_from_spectrum": "reml", "NullModel": "reml",
            "fit_null_model": "reml", "h2_profile_ci": "reml",
            "emmax_scan_stats": "scan", "RotatedNull": "scan",
            "build_rotated_null": "scan"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(
            f"mixmogam_tpu_torch.ops.{_EXPORTS[name]}"), name)
    raise AttributeError(
        f"module 'mixmogam_tpu_torch.ops' has no attribute {name!r}")
