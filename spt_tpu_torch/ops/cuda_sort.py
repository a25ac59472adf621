"""The chunked sort for Hopper: ``sort_chunks``.

The counterpart of ``spt_tpu.ops.pallas_sort.sort_chunks`` (K5, :111): sort
a key and up to ``MAX_OPERANDS`` payload planes within fixed chunks.  Keys
are int64 tensors holding uint32 values (dead lanes 0xFFFFFFFF land last);
payload planes are 4- or 8-byte tensors (float32, int32, int64) of the
key's length.  Returns (sorted keys, lane ids, sorted planes): lane id i is
the pre-sort position of the lane now at i.  The sort is stable: lanes of
equal keys keep their order, so every output equals
``sort_chunks_reference``'s bit for bit.

On a CUDA tensor it launches the kernel of ``csrc/sort_chunks.cu`` once
(a cluster of up to 16 blocks per chunk runs a stable radix sort of key
and local lane through distributed shared memory, then each block gathers
every plane for its tile) or raises; chunks are powers of two from 2 to
``MAX_CHUNK``.  Before the first launch at a chunk size it checks that the
device can hold one cluster of that shape and raises, naming the shape,
when it cannot.  On a CPU tensor it runs ``sort_chunks_reference``:
``torch.sort`` per chunk plus a gather per plane.  ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from spt_tpu_torch.ops import cuda_lib

LAUNCHES = 0
MAX_OPERANDS = 16
MAX_CHUNK = 32768

# (device index, chunk) whose cluster shape the device was found to hold
_FITS: set = set()


def sort_chunks_reference(key: torch.Tensor, operands, chunk: int):
    """Plain version: a stable torch.sort within each chunk and a gather of
    every plane through the permutation."""
    n = key.shape[0]
    sk, idx = torch.sort(key.reshape(-1, chunk), dim=1, stable=True)
    base = torch.arange(0, n, chunk, dtype=torch.int64, device=key.device)
    lane_id = (idx + base[:, None]).reshape(n)
    outs = [a.reshape(-1, chunk).gather(1, idx).reshape(n) for a in operands]
    return sk.reshape(n), lane_id, outs


def sort_chunks(key: torch.Tensor, operands, chunk: int):
    global LAUNCHES
    device = key.device
    if device.type == "cpu":
        return sort_chunks_reference(key, operands, chunk)
    if device.type != "cuda":
        raise ValueError(f"sort_chunks runs on CUDA or CPU tensors, not {device}")
    n = key.shape[0]
    if key.dtype != torch.int64 or key.dim() != 1 or not key.is_contiguous():
        raise ValueError("the key must be a contiguous (N,) int64 tensor")
    if (chunk < 2 or chunk > MAX_CHUNK or chunk & (chunk - 1) or n % chunk):
        raise ValueError(f"chunk {chunk} must be a power of two <= "
                         f"{MAX_CHUNK} dividing {n}")
    if len(operands) > MAX_OPERANDS:
        raise ValueError(f"{len(operands)} operands > {MAX_OPERANDS}")
    for a in operands:
        if (a.device != device or a.shape != (n,) or not a.is_contiguous()
                or a.element_size() not in (4, 8)):
            raise ValueError(f"operands must be contiguous ({n},) tensors of "
                             f"4- or 8-byte elements on {device}")
    outs = [torch.empty_like(a) for a in operands]
    o_key = torch.empty_like(key)
    o_lane = torch.empty(n, dtype=torch.int64, device=device)
    k = len(operands)
    ins = (ctypes.c_void_p * max(k, 1))(*(a.data_ptr() for a in operands))
    outp = (ctypes.c_void_p * max(k, 1))(*(a.data_ptr() for a in outs))
    sizes = (ctypes.c_int * max(k, 1))(*(a.element_size() for a in operands))
    lib = cuda_lib.build()
    with torch.cuda.device(device):
        if (device.index, chunk) not in _FITS:
            _check_fits(device, chunk)
        err = lib.spt_sort_chunks(
            key.data_ptr(), o_key.data_ptr(), o_lane.data_ptr(),
            ctypes.addressof(ins), ctypes.addressof(outp),
            ctypes.addressof(sizes), k, n, chunk, cuda_lib.stream_of(device))
    cuda_lib.check(err, "sort_chunks")
    LAUNCHES += 1
    return o_key, o_lane, outs


def _check_fits(device, chunk: int) -> None:
    """Raise unless the current device holds at least one cluster of the
    sort's shape at `chunk`."""
    info = cuda_lib.sort_kernel_info(chunk)
    if info["active_clusters"] < 1:
        raise RuntimeError(
            f"sort_chunks at chunk {chunk}: {torch.cuda.get_device_name(device)}"
            f" holds no cluster of {info['cluster']} blocks of "
            f"{info['threads']} threads with {info['smem_bytes']} B of shared "
            f"memory each (cudaOccupancyMaxActiveClusters gives 0)")
    _FITS.add((device.index, chunk))
