// Constants every encoder attention kernel shares. The kernels build on
// attention_mma.cuh (bf16 on the tensor cores) and attention_tf32.cuh (f32
// on the tensor cores in split TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int D = 64;          // head dim of K1, K2, K5 and K7
constexpr int KMAX = 256;      // most keys a whole-window kernel holds (16 x 16)

}  // namespace attn
