#!/usr/bin/env python3
"""How fast the card takes the store patterns of a dense int8 output.

    python3 scripts/torch_store_pattern_probe.py

Each pattern writes a (rows, n) int8 matrix of about 228 MB (the size of the
(64, 1889, 1889) dense adjacency) with a 0/1 value computed from the
indices, no other work, and is timed by CUDA events (median of 20 launches):

* ``block32``: a warp writes a 32x32 block, row by row, one byte a lane (32
  contiguous bytes a store), as ``trim_adjacency.cu`` stores a block at any
  N;
* ``block32_words``: the same blocks, each 32-byte row segment as two
  stores: the whole 4-byte words inside it (8 lanes a segment, 4 segments a
  store), then the at most four bytes at its ends that share a word with the
  neighbouring segment; ``block32_bytes_first`` stores those bytes first;
* ``run128``: a warp writes 32 rows of 128 contiguous bytes, four such stores
  a row;
* ``pairs16``: a warp writes a 32x32 block as 16-byte vectors, two lanes a
  row segment, 16 segments a store (``trim_adjacency.cu`` at N % 16 == 0);
* ``lines``: a warp writes 512 contiguous bytes of a row a store, 16 a lane.

Row lengths 1889 (rows start at any byte), 1892 and 1896 (4- and 8-byte
aligned rows), 1888 (16-byte aligned rows) and 1920 (128-byte aligned rows)
show what alignment does to each. Prints the
card's name and power limit, then one JSON line a pattern. Needs ``nvcc``
and a card; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOTAL_BYTES = 64 * 1889 * 1889

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int8_t value(long long row, int col) {
  return static_cast<int8_t>((row ^ col) & 1);
}

__device__ __forceinline__ uint32_t expand4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__global__ void block32(int8_t* out, long long rows, int n) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_row = (n + 31) / 32;
  const long long row0 = 32 * (warp / per_row);
  const int col = static_cast<int>(32 * (warp % per_row)) + lane;
  if (row0 >= rows || col >= n) return;
  for (int r = 0; r < 32 && row0 + r < rows; ++r) {
    out[(row0 + r) * n + col] = value(row0 + r, col);
  }
}

// block32 split in two stores a row segment: the 4-byte words inside it, then
// the at most four bytes at its ends that share a word with the next segment
// (`bytes_first` swaps the two)
template <bool bytes_first>
__global__ void block32w(int8_t* out, long long rows, int n) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_row = (n + 31) / 32;
  const long long row0 = 32 * (warp / per_row);
  const int col0 = static_cast<int>(32 * (warp % per_row));
  if (row0 >= rows || col0 + 32 > n) return;
  const int seg = lane >> 3, k = lane & 7;
  for (int q = 0; q < 8; ++q) {
    const long long row = row0 + 4 * q + seg;
    if (row >= rows) continue;
    int8_t* p = out + row * n + col0;
    const int d = static_cast<int>((4 - (reinterpret_cast<uintptr_t>(p) & 3)) & 3);
    const uint32_t bits = static_cast<uint32_t>(row ^ col0) & 1u ? 0x55555555u : 0xAAAAAAAAu;
    const int off = k < d ? k : 28 + k;
    const bool edge = k < 4 && d != 0;
    if (bytes_first && edge) p[off] = static_cast<int8_t>((bits >> off) & 1u);
    if (d + 4 * k + 4 <= 32) {
      *reinterpret_cast<uint32_t*>(p + d + 4 * k) = expand4(bits >> (d + 4 * k));
    }
    if (!bytes_first && edge) p[off] = static_cast<int8_t>((bits >> off) & 1u);
  }
}

__global__ void run128(int8_t* out, long long rows, int n) {
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_row = (n + 127) / 128;
  const long long row0 = 32 * (warp / per_row);
  const int col0 = static_cast<int>(128 * (warp % per_row));
  if (row0 >= rows) return;
  for (int r = 0; r < 32 && row0 + r < rows; ++r) {
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + 32 * c + lane;
      if (col < n) out[(row0 + r) * n + col] = value(row0 + r, col);
    }
  }
}

__global__ void pairs16(int8_t* out, long long rows, int n) {  // n % 16 == 0
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_row = (n + 31) / 32;
  const long long row0 = 32 * (warp / per_row);
  const int col = static_cast<int>(32 * (warp % per_row)) + 16 * (lane & 1);
  if (row0 >= rows) return;
  for (int q = 0; q < 2; ++q) {
    const long long row = row0 + 16 * q + (lane >> 1);
    if (row < rows && col < n) {
      const uint32_t bits = static_cast<uint32_t>(row ^ col) & 1u ? 0x5555u : 0xAAAAu;
      *reinterpret_cast<uint4*>(out + row * n + col) = make_uint4(
          expand4(bits), expand4(bits >> 4), expand4(bits >> 8), expand4(bits >> 12));
    }
  }
}

__global__ void lines(int8_t* out, long long rows, int n) {  // n % 16 == 0
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_row = (n + 511) / 512;
  const long long row = warp / per_row;
  const int col = static_cast<int>(512 * (warp % per_row)) + 16 * lane;
  if (row >= rows || col >= n) return;
  const uint32_t bits = static_cast<uint32_t>(row ^ col) & 1u ? 0x5555u : 0xAAAAu;
  *reinterpret_cast<uint4*>(out + row * n + col) = make_uint4(
      expand4(bits), expand4(bits >> 4), expand4(bits >> 8), expand4(bits >> 12));
}

extern "C" int launch(int pattern, int8_t* out, long long rows, int n, cudaStream_t stream) {
  long long warps;
  switch (pattern) {
    case 0: warps = ((rows + 31) / 32) * ((n + 31) / 32); break;
    case 1: warps = ((rows + 31) / 32) * ((n + 127) / 128); break;
    case 2: case 4: case 5: warps = ((rows + 31) / 32) * ((n + 31) / 32); break;
    default: warps = rows * ((n + 511) / 512); break;
  }
  const unsigned blocks = static_cast<unsigned>((warps + 7) / 8);
  switch (pattern) {
    case 0: block32<<<blocks, 256, 0, stream>>>(out, rows, n); break;
    case 1: run128<<<blocks, 256, 0, stream>>>(out, rows, n); break;
    case 2: pairs16<<<blocks, 256, 0, stream>>>(out, rows, n); break;
    case 4: block32w<false><<<blocks, 256, 0, stream>>>(out, rows, n); break;
    case 5: block32w<true><<<blocks, 256, 0, stream>>>(out, rows, n); break;
    default: lines<<<blocks, 256, 0, stream>>>(out, rows, n); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""

PATTERNS = {"block32": (0, (1889, 1892, 1896, 1888, 1920)),
            "block32_words": (4, (1889, 1892, 1920)),
            "block32_bytes_first": (5, (1889,)), "run128": (1, (1889, 1920)),
            "pairs16": (2, (1888, 1920)), "lines": (3, (1920,))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_store_pattern_probe: no CUDA device", file=sys.stderr)
        return 1
    from teaserpp_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "patterns.cu", Path(tmp) / "libpatterns.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_void_p]
        lib.launch.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        for name, (pattern, widths) in PATTERNS.items():
            for n in widths:
                rows = TOTAL_BYTES // n
                out = torch.empty((rows, n), dtype=torch.int8, device="cuda")
                times = []
                for _ in range(21):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    if lib.launch(pattern, out.data_ptr(), rows, n, stream) != 0:
                        raise RuntimeError(f"{name} did not launch")
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                ms = statistics.median(times[1:])
                print(json.dumps(dict(pattern=name, n=n, rows=rows, bytes=rows * n, ms=ms,
                                      gb_per_s=rows * n / ms / 1e6, card=card)), flush=True)
                del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
