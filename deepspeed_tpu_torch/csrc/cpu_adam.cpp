// SIMD CPU Adam — TPU-host rebuild of the reference's AVX Adam
// (csrc/adam/cpu_adam.cpp:21, SIMD macros csrc/includes/cpu_adam.h:25-41).
//
// Runs the ZeRO-Offload optimizer step on the TPU-VM host over fp32 numpy
// views. Auto-vectorized hot loop (-O3 -march=native turns it into
// AVX2/AVX-512 or NEON depending on the host) + OpenMP across chunks —
// same design point as the reference, without hand-written intrinsics so
// one source serves x86 and aarch64 TPU-VM hosts.
//
// C ABI for ctypes: see deepspeed_tpu/ops/native/cpu_adam.py.

#include <cmath>
#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// One fused Adam/AdamW step over a flat fp32 tensor, in place.
void ds_adam_step(float* params,
                  const float* grads,
                  float* exp_avg,
                  float* exp_avg_sq,
                  int64_t n,
                  int64_t step,
                  float lr,
                  float beta1,
                  float beta2,
                  float eps,
                  float weight_decay,
                  int adamw_mode,
                  int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  const float omb1 = 1.0f - beta1;
  const float omb2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2_sqrt = 1.0f / std::sqrt(bc2);

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    float p = params[i];
    if (weight_decay != 0.0f && !adamw_mode) g += weight_decay * p;
    float m = beta1 * exp_avg[i] + omb1 * g;
    float v = beta2 * exp_avg_sq[i] + omb2 * g * g;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) * inv_bc2_sqrt + eps;
    float update = (m * inv_bc1) / denom;
    if (weight_decay != 0.0f && adamw_mode) update += weight_decay * p;
    params[i] = p - lr * update;
  }
}

// Round-to-nearest-even fp32→bf16 with a NaN guard: the rounding add would
// otherwise carry a high-mantissa NaN through the exponent into ±0/Inf —
// and NaNs (fp16-overflow markers) are exactly what the offload staging
// must preserve for the skip-step logic.
static inline uint16_t fp32_bits_to_bf16(uint32_t bits) {
  if ((bits & 0x7F800000u) == 0x7F800000u && (bits & 0x007FFFFFu)) {
    return (uint16_t)(((bits >> 16) & 0x8000u) | 0x7FC0u);
  }
  uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return (uint16_t)((bits + rounding) >> 16);
}

// Same step but also writes a bf16 copy of the updated params (the tile the
// reference copies back to GPU overlapped with compute, cpu_adam.cpp:67).
void ds_adam_step_plus_copy(float* params,
                            const float* grads,
                            float* exp_avg,
                            float* exp_avg_sq,
                            uint16_t* params_bf16,
                            int64_t n,
                            int64_t step,
                            float lr,
                            float beta1,
                            float beta2,
                            float eps,
                            float weight_decay,
                            int adamw_mode,
                            int bias_correction) {
  ds_adam_step(params, grads, exp_avg, exp_avg_sq, n, step, lr, beta1, beta2,
               eps, weight_decay, adamw_mode, bias_correction);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    __builtin_memcpy(&bits, &params[i], 4);
    params_bf16[i] = fp32_bits_to_bf16(bits);
  }
}

// Extended single-pass step for the pipelined offload tier
// (runtime/zero/offload.py step_streamed): reads grads directly in their
// wire dtype (bf16 halves the d2h bytes) with the unscale/clip coefficient
// folded into the read, updates master fp32 params + moments, and emits
// the bf16 copy the engine pushes back to the device — one memory pass
// where the unextended path needed three (widen, scale, step) plus a
// separate conversion pass. The reference overlaps the same stages with
// CUDA streams (csrc/adam/cpu_adam.cpp:67-120).
void ds_adam_step_ex(float* params,
                     const void* grads,
                     int grads_bf16,      // 1: grads are bf16 (uint16 bits)
                     float grad_scale,    // multiplied into every grad read
                     float* exp_avg,
                     float* exp_avg_sq,
                     uint16_t* params_bf16_out,  // nullable
                     int64_t n,
                     int64_t step,
                     float lr,
                     float beta1,
                     float beta2,
                     float eps,
                     float weight_decay,
                     int adamw_mode,
                     int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  const float omb1 = 1.0f - beta1;
  const float omb2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2_sqrt = 1.0f / std::sqrt(bc2);
  const float* gf = static_cast<const float*>(grads);
  const uint16_t* gh = static_cast<const uint16_t*>(grads);

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g;
    if (grads_bf16) {
      uint32_t bits = ((uint32_t)gh[i]) << 16;
      __builtin_memcpy(&g, &bits, 4);
    } else {
      g = gf[i];
    }
    g *= grad_scale;
    float p = params[i];
    if (weight_decay != 0.0f && !adamw_mode) g += weight_decay * p;
    float m = beta1 * exp_avg[i] + omb1 * g;
    float v = beta2 * exp_avg_sq[i] + omb2 * g * g;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) * inv_bc2_sqrt + eps;
    float update = (m * inv_bc1) / denom;
    if (weight_decay != 0.0f && adamw_mode) update += weight_decay * p;
    p -= lr * update;
    params[i] = p;
    if (params_bf16_out) {
      uint32_t bits;
      __builtin_memcpy(&bits, &p, 4);
      params_bf16_out[i] = fp32_bits_to_bf16(bits);
    }
  }
}

// LAMB twin of ds_adam_step_ex (trust-ratio semantics of ds_lamb_step).
void ds_lamb_step_ex(float* params,
                     const void* grads,
                     int grads_bf16,
                     float grad_scale,
                     float* exp_avg,
                     float* exp_avg_sq,
                     float* update_buf,   // scratch, n floats
                     uint16_t* params_bf16_out,  // nullable
                     int64_t n,
                     int64_t step,
                     float lr,
                     float beta1,
                     float beta2,
                     float eps,
                     float weight_decay,
                     float max_coeff,
                     float min_coeff,
                     int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  const float omb1 = 1.0f - beta1;
  const float omb2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2_sqrt = 1.0f / std::sqrt(bc2);
  const float* gf = static_cast<const float*>(grads);
  const uint16_t* gh = static_cast<const uint16_t*>(grads);

  double p_sq = 0.0, u_sq = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : p_sq, u_sq)
  for (int64_t i = 0; i < n; ++i) {
    float g;
    if (grads_bf16) {
      uint32_t bits = ((uint32_t)gh[i]) << 16;
      __builtin_memcpy(&g, &bits, 4);
    } else {
      g = gf[i];
    }
    g *= grad_scale;
    float p = params[i];
    float m = beta1 * exp_avg[i] + omb1 * g;
    float v = beta2 * exp_avg_sq[i] + omb2 * g * g;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) * inv_bc2_sqrt + eps;
    float u = (m * inv_bc1) / denom;
    if (weight_decay != 0.0f) u += weight_decay * p;
    update_buf[i] = u;
    p_sq += (double)p * p;
    u_sq += (double)u * u;
  }
  float trust = 1.0f;
  if (p_sq > 0.0 && u_sq > 0.0) {
    trust = (float)(std::sqrt(p_sq) / std::sqrt(u_sq));
    if (trust > max_coeff) trust = max_coeff;
    if (trust < min_coeff) trust = min_coeff;
  }
  const float step_size = lr * trust;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float p = params[i] - step_size * update_buf[i];
    params[i] = p;
    if (params_bf16_out) {
      uint32_t bits;
      __builtin_memcpy(&bits, &p, 4);
      params_bf16_out[i] = fp32_bits_to_bf16(bits);
    }
  }
}

// Multi-tensor apply (reference csrc/adam/multi_tensor_adam.cu:163 /
// multi_tensor_apply.cuh): one call steps a whole parameter list. The
// OpenMP region spans all tensors so small leaves don't serialize on
// per-call fork/join.
void ds_adam_step_multi(float** params,
                        const float** grads,
                        float** exp_avg,
                        float** exp_avg_sq,
                        const int64_t* sizes,
                        int64_t n_tensors,
                        int64_t step,
                        float lr,
                        float beta1,
                        float beta2,
                        float eps,
                        float weight_decay,
                        int adamw_mode,
                        int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  const float omb1 = 1.0f - beta1;
  const float omb2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2_sqrt = 1.0f / std::sqrt(bc2);

#pragma omp parallel
  for (int64_t t = 0; t < n_tensors; ++t) {
    float* p_ = params[t];
    const float* g_ = grads[t];
    float* m_ = exp_avg[t];
    float* v_ = exp_avg_sq[t];
    const int64_t n = sizes[t];
#pragma omp for schedule(static) nowait
    for (int64_t i = 0; i < n; ++i) {
      float g = g_[i];
      float p = p_[i];
      if (weight_decay != 0.0f && !adamw_mode) g += weight_decay * p;
      float m = beta1 * m_[i] + omb1 * g;
      float v = beta2 * v_[i] + omb2 * g * g;
      m_[i] = m;
      v_[i] = v;
      float denom = std::sqrt(v) * inv_bc2_sqrt + eps;
      float update = (m * inv_bc1) / denom;
      if (weight_decay != 0.0f && adamw_mode) update += weight_decay * p;
      p_[i] = p - lr * update;
    }
  }
}

// Host LAMB step over one flat tensor (reference
// csrc/lamb/fused_lamb_cuda_kernel.cu:469): Adam-style update, then a
// per-tensor trust ratio ||p|| / ||update|| clamped to
// [min_coeff, max_coeff]. Two-pass: the norms need the full update before
// any element of p moves.
void ds_lamb_step(float* params,
                  const float* grads,
                  float* exp_avg,
                  float* exp_avg_sq,
                  float* update_buf,   // scratch, n floats
                  int64_t n,
                  int64_t step,
                  float lr,
                  float beta1,
                  float beta2,
                  float eps,
                  float weight_decay,
                  float max_coeff,
                  float min_coeff,
                  int bias_correction) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  const float omb1 = 1.0f - beta1;
  const float omb2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2_sqrt = 1.0f / std::sqrt(bc2);

  double p_sq = 0.0, u_sq = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : p_sq, u_sq)
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    float p = params[i];
    float m = beta1 * exp_avg[i] + omb1 * g;
    float v = beta2 * exp_avg_sq[i] + omb2 * g * g;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) * inv_bc2_sqrt + eps;
    float u = (m * inv_bc1) / denom;
    if (weight_decay != 0.0f) u += weight_decay * p;
    update_buf[i] = u;
    p_sq += (double)p * p;
    u_sq += (double)u * u;
  }
  float trust = 1.0f;
  if (p_sq > 0.0 && u_sq > 0.0) {
    trust = (float)(std::sqrt(p_sq) / std::sqrt(u_sq));
    if (trust > max_coeff) trust = max_coeff;
    if (trust < min_coeff) trust = min_coeff;
  }
  const float step_size = lr * trust;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    params[i] -= step_size * update_buf[i];
  }
}

// Staging conversions for the offload tiers (the reference's overlapped
// fp16 copy tiles, cpu_adam.cpp:67): round-to-nearest-even fp32→bf16 and
// the exact widening bf16→fp32.
void ds_fp32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    __builtin_memcpy(&bits, &src[i], 4);
    dst[i] = fp32_bits_to_bf16(bits);
  }
}

void ds_bf16_to_fp32(const uint16_t* src, float* dst, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits = ((uint32_t)src[i]) << 16;
    __builtin_memcpy(&dst[i], &bits, 4);
  }
}

// L2 norm over a flat tensor (fp64 accumulation) — host-side grad-norm for
// the offload clip path.
double ds_l2_norm_sq(const float* x, int64_t n) {
  double acc = 0.0;
#pragma omp parallel for schedule(static) reduction(+ : acc)
  for (int64_t i = 0; i < n; ++i) acc += (double)x[i] * x[i];
  return acc;
}

int ds_adam_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
