"""Hand-written Hopper kernels of the port, one package per TPU kernel
module of ``repro.kernels``: ``<name>/kernel.py`` (the kernel's wrapper, with
its launch count), ``<name>/ref.py`` (the plain PyTorch version) and
``<name>/ops.py`` (the public op, dispatching on the tensor's device).
CUDA C++ sources live in ``csrc/`` and are built by ``_build``.
"""
from .decode_attention.kernel import decode_attention_chunked_cuda, decode_attention_cuda
from .flash_attention.kernel import flash_attention_cuda, flash_attention_wgmma_cuda
from .gelu.kernel import gelu_cuda, gelu_mul_cuda, silu_mul_triton
from .matmul.kernel import (matmul_cuda, matmul_f32_tma_cuda, matmul_int8_cuda,
                            matmul_int8_wgmma_cuda, matmul_reduce_cuda, matmul_wgmma_cuda)
from .rglru.kernel import rglru_chunked_cuda, rglru_cuda
from .rmsnorm.kernel import layernorm_triton, rmsnorm_triton
from .wkv.kernel import wkv_chunked_cuda, wkv_cuda

#: every kernel wrapper of the port, by kernel name
KERNELS = {
    "rmsnorm": rmsnorm_triton,
    "layernorm": layernorm_triton,
    "gelu": gelu_cuda,
    "gelu_mul": gelu_mul_cuda,
    "silu_mul": silu_mul_triton,
    "flash_attention": flash_attention_cuda,
    "flash_attention_wgmma": flash_attention_wgmma_cuda,
    "decode_attention": decode_attention_cuda,
    "decode_attention_chunked": decode_attention_chunked_cuda,
    "wkv": wkv_cuda,
    "wkv_chunked": wkv_chunked_cuda,
    "rglru": rglru_cuda,
    "rglru_chunked": rglru_chunked_cuda,
    "matmul": matmul_cuda,
    "matmul_wgmma": matmul_wgmma_cuda,
    "matmul_f32_tma": matmul_f32_tma_cuda,
    "matmul_reduce": matmul_reduce_cuda,
    "matmul_int8": matmul_int8_cuda,
    "matmul_int8_wgmma": matmul_int8_wgmma_cuda,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "launches", "reset_launches"]
