// CPU stand-in for what the port's kernels take from the driver API's
// cuda.h (see cuda_runtime.h in this directory): the tiled tensor map of
// the Tensor Memory Accelerator, encoded by cuTensorMapEncodeTiled as the
// runtime's cudaGetDriverEntryPoint hands it out, and its 4-D tile load
// into shared memory. The load copies the box at the given coordinates
// (innermost first, negative allowed), zeros for every element outside the
// tensor, packed in box order, and completes the barrier's transaction by
// the box's bytes. The encoder refuses what the card's refuses among the
// rules the kernels meet (rank 1-5, a 16-byte aligned base, strides that
// are multiples of 16, box sizes 1-256 whose inner bytes are a multiple of
// 16); the load records a misaligned address for a destination not 128-byte
// aligned.
#pragma once

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
enum CUtensorMapDataType {
  CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0,
  CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9
};
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0 };
enum CUtensorMapL2promotion {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2
};
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

// the card's is 128 opaque bytes; the stand-in keeps the fields it reads
struct alignas(64) CUtensorMap {
  const char* base;
  int rank, elem;
  uint64_t dim[5], stride[5];
  uint32_t box[5];
};

inline CUresult emu_tensor_map_encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                                            cuuint32_t rank, void* base, const cuuint64_t* dim,
                                            const cuuint64_t* strides, const cuuint32_t* box,
                                            const cuuint32_t* elem_strides,
                                            CUtensorMapInterleave, CUtensorMapSwizzle,
                                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  const int elem = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1
                   : type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : 4;
  if (rank < 1 || rank > 5 || !emu_aligned(base, 16)) return CUDA_ERROR_INVALID_VALUE;
  std::memset(map, 0, sizeof *map);
  map->base = static_cast<const char*>(base);
  map->rank = (int)rank;
  map->elem = elem;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (dim[i] == 0 || box[i] == 0 || box[i] > 256 || elem_strides[i] != 1)
      return CUDA_ERROR_INVALID_VALUE;
    map->dim[i] = dim[i];
    map->box[i] = box[i];
    map->stride[i] = i == 0 ? (uint64_t)elem : strides[i - 1];
    if (i > 0 && map->stride[i] % 16) return CUDA_ERROR_INVALID_VALUE;
  }
  if (box[0] * elem % 16) return CUDA_ERROR_INVALID_VALUE;
  return CUDA_SUCCESS;
}

typedef int cudaDriverEntryPointQueryResult;
enum { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPoint(const char* symbol, void** fn, unsigned long long,
                                           cudaDriverEntryPointQueryResult* status) {
  const bool found = std::strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = found ? reinterpret_cast<void*>(&emu_tensor_map_encode_tiled) : nullptr;
  if (status) *status = found ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}

// cp.async.bulk.tensor.4d ... mbarrier::complete_tx::bytes
inline void emu_tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                            void* bar) {
  if (!emu_aligned(dst, 128) || map->rank != 4) {
    emu_fault(cudaErrorMisalignedAddress);
    return;
  }
  const long long at[4] = {c0, c1, c2, c3};
  char* out = static_cast<char*>(dst);
  long long bytes = 0;
  for (uint32_t i3 = 0; i3 < map->box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < map->box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < map->box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < map->box[0]; ++i0) {
          const long long idx[4] = {at[0] + i0, at[1] + i1, at[2] + i2, at[3] + i3};
          bool inside = true;
          uint64_t off = 0;
          for (int d = 0; d < 4; ++d) {
            inside = inside && idx[d] >= 0 && (uint64_t)idx[d] < map->dim[d];
            off += (uint64_t)(idx[d] < 0 ? 0 : idx[d]) * map->stride[d];
          }
          if (inside)
            std::memcpy(out, map->base + off, map->elem);
          else
            std::memset(out, 0, map->elem);
          out += map->elem;
          bytes += map->elem;
        }
  std::lock_guard<std::mutex> lock(emu_block_sync->m);
  emu_mbar_update(bar, 0, -bytes);
}
