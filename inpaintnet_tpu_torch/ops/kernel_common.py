"""Shared pieces for the hand-written CUDA kernels.

- ``round_up``, ``gru_gates_f32`` and ``lstm_gates_f32``: the torch-order
  [r, z, n] GRU and [i, f, g, o] LSTM gate math in f32 (one copy for every
  plain version; the CUDA copies are ``csrc/gru_common.cuh gru_gate`` and
  ``csrc/arnn_decode.cu lstm_gate``).
- The build: ``nvcc`` compiles every ``csrc/*.cu`` (one process per source,
  in parallel) and links them into one shared library with a plain C
  interface, at first use, keyed on the hash of the sources, into
  ``build/inpaintnet_tpu_torch/`` at the repository root. It is loaded
  with ``ctypes``.
- ``pack_mma_b`` and ``pack_mma_b_s8``: the weight layouts the bf16 and the
  int8 ``mma.sync`` kernels read (the Hopper encoder's are
  ``encoder_kernel.pack_gate_slabs`` and plain transposes).
- ``check_cuda_tensor``: the wrappers' argument checks.

Nothing here imports or builds anything at import time: this module is
imported on machines without ``nvcc`` or a GPU, where only the plain
versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "inpaintnet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def gru_gates_f32(xw, hw, h_prev, hidden: int):
    """Torch-order [r, z, n] GRU gate math in f32, with the products (and
    their biases) precomputed by the caller."""
    r = torch.sigmoid(xw[:, :hidden] + hw[:, :hidden])
    z = torch.sigmoid(xw[:, hidden : 2 * hidden] + hw[:, hidden : 2 * hidden])
    n = torch.tanh(xw[:, 2 * hidden :] + r * hw[:, 2 * hidden :])
    return (1.0 - z) * n + z * h_prev


def lstm_gates_f32(xw, hw, c_prev, hidden: int):
    """Torch-order [i, f, g, o] LSTM gate math in f32, with the products (and
    their biases) precomputed by the caller
    (``inpaintnet_tpu/ops/pallas_common.py lstm_gates_f32``).

    :return: (h_new, c_new)
    """
    gates = xw + hw
    i = torch.sigmoid(gates[:, :hidden])
    f = torch.sigmoid(gates[:, hidden : 2 * hidden])
    g = torch.tanh(gates[:, 2 * hidden : 3 * hidden])
    o = torch.sigmoid(gates[:, 3 * hidden :])
    c_new = f * c_prev + i * g
    return o * torch.tanh(c_new), c_new


def kernel_supports_hidden(hidden: int) -> bool:
    """Hidden widths K1-K6 take, bf16/f32 (K1, K2, K5, K6) and int8 (K3,
    K4) alike: whole 64-unit chunks (so every product depth is a multiple of
    the int8 ``mma`` depth of 32, and the bf16 one of 16), and a row tile
    that fits one block's shared memory (up to the flagship's 512). K7 and
    K8 have gates of their own (``arnn_kernel.arnn_kernel_supports``,
    :func:`gru_layer_supports_hidden`)."""
    return hidden % 64 == 0 and hidden <= 512


def gru_layer_supports_hidden(hidden: int) -> bool:
    """Hidden widths K8 (``csrc/gru_layer.cu``) takes: whole 64-unit chunks
    up to 1024, the LatentRNN's generation GRU (H * layers). Its shared
    memory at 1024: 132 KB for a 32-row bf16 tile double-buffered, 160 KB
    for the f32 route's k-major carry, both inside the 227 KB opt-in."""
    return hidden % 64 == 0 and 0 < hidden <= 1024


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
                       "kernels cannot be built")


def _run_all(cmds, verbose: bool) -> None:
    """Run the commands at once, wait for all of them, and raise on the
    first that failed (printing every output when ``verbose``)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}")


def build_kernels(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``libkernels_<hash>.so`` unless a library
    of the same sources exists: one ``nvcc -c`` per source, all started
    together, then one link. Returns its path; raises on a failed build."""
    lib = BUILD_DIR / f"libkernels_{sources_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]
        _run_all([[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                   "-o", obj, str(src)]
                  for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)], verbose)
        so = str(Path(tmp) / lib.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]], verbose)
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's ``argtypes`` set (an unset one would pass pointers as 32-bit
    ints)."""
    lib = ctypes.CDLL(str(build_kernels()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.inpaint_encoder_hn_f32.argtypes = [ptr] * 15 + [i32] * 4 + [ptr]
    lib.inpaint_encoder_hn_f32.restype = i32
    lib.inpaint_encoder_rec_bf16.argtypes = [i32] + [ptr] * 8 + [i32] * 6 + [ptr]
    lib.inpaint_encoder_rec_bf16.restype = i32
    lib.inpaint_encoder_gemm_bf16.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
    lib.inpaint_encoder_gemm_bf16.restype = i32
    lib.inpaint_decode_sampling.argtypes = [i32] + [ptr] * 13 + [i32] * 4 + [ptr]
    lib.inpaint_decode_sampling.restype = i32
    lib.inpaint_encoder_rec_int8.argtypes = [i32] * 2 + [ptr] * 10 + [i32] * 6 + [ptr]
    lib.inpaint_encoder_rec_int8.restype = i32
    lib.inpaint_encoder_gemm_int8.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    lib.inpaint_encoder_gemm_int8.restype = i32
    lib.inpaint_decode_sampling_int8.argtypes = [i32] + [ptr] * 16 + [i32] * 4 + [ptr]
    lib.inpaint_decode_sampling_int8.restype = i32
    lib.inpaint_gru_fwd_seq.argtypes = [i32] + [ptr] * 5 + [i32] * 4 + [ptr]
    lib.inpaint_gru_fwd_seq.restype = i32
    lib.inpaint_gru_bwd_seq.argtypes = [i32] + [ptr] * 10 + [i32] * 4 + [ptr]
    lib.inpaint_gru_bwd_seq.restype = i32
    lib.inpaint_arnn_decode.argtypes = [i32] + [ptr] * 16 + [i32] * 7 + [ptr]
    lib.inpaint_arnn_decode.restype = i32
    lib.inpaint_gru_layer.argtypes = [i32] + [ptr] * 7 + [i32] * 5 + [ptr]
    lib.inpaint_gru_layer.restype = i32
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` from a C entry point: a refused
    launch never runs, and a later synchronise would not report it."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_cuda_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels take raw pointers and trust all four."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def pack_mma_b_s8(w: torch.Tensor) -> torch.Tensor:
    """Reorder a (K, N) int8 weight into the ``mma.sync m16n8k32`` s8
    B-fragment order the int8 kernels load (``gru_common.cuh GemmS8``): for
    each 8-column tile and 32-row k-tile, lane ``l = 4 * r + q`` holds
    ``w[k0 + 4q + {0..3}, n0 + r]`` then ``w[k0 + 16 + 4q + {0..3}, n0 + r]``
    as eight contiguous bytes."""
    if w.dtype != torch.int8:
        raise ValueError(f"pack_mma_b_s8: takes int8, got {w.dtype}")
    K, N = w.shape
    if K % 32 or N % 8:
        raise ValueError(f"pack_mma_b_s8: shape {(K, N)} needs K % 32 == 0 and N % 8 == 0")
    # k = kt*32 + half*16 + q*4 + p ; n = nt*8 + r  ->  (nt, kt, r, q, half, p)
    return w.reshape(K // 32, 2, 4, 4, N // 8, 8).permute(4, 0, 5, 2, 1, 3).contiguous()


def pack_mma_b(w: torch.Tensor) -> torch.Tensor:
    """Reorder a (K, N) bf16 weight into the ``mma.sync m16n8k16`` B-fragment
    order the kernels load (``gru_common.cuh Gemm``): for each 8-column tile
    and 16-row k-tile, lane ``l = 4 * r + q`` holds
    ``w[k0 + 2q + {0, 1, 8, 9}, n0 + r]`` as four contiguous values.
    f32 weights stay (K, N): the f32 route reads them as they are."""
    if w.dtype != torch.bfloat16:
        return w.contiguous()
    K, N = w.shape
    if K % 16 or N % 8:
        raise ValueError(f"pack_mma_b: shape {(K, N)} needs K % 16 == 0 and N % 8 == 0")
    # k = kt*16 + half*8 + q*2 + p ; n = nt*8 + r  ->  (nt, kt, r, q, half, p)
    return w.reshape(K // 16, 2, 4, 2, N // 8, 8).permute(4, 0, 5, 2, 1, 3).contiguous()
