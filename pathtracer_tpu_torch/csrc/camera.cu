// Primary rays of a progressive iteration for Hopper (sm_90a): the camera
// stream of the counter hash and the jittered pinhole or thin-lens ray, one
// launch for a wavefront of lanes.
//
// Replaces no TPU kernel.  The JAX package leaves this to XLA, which fuses
// pathtracer_tpu/ops/rng.py:hash_uniforms and ops/camera.py:
// generate_camera_rays into one loop; in the port they ran as plain PyTorch
// ops (pathtracer_tpu_torch/ops/rng.py, ops/camera.py), the hash as int64
// tensors masked to 32 bits with every product split into 16-bit halves:
// about 160 elementwise passes over the lanes and 258 launches a spp of a
// 3840x2160 render, 10.4 ms of device time a spp on the H100 (PERF.md).
// The plain ops stay as the CPU path and as the differentiable path.
//
// Per lane it reads the pixel index and the global sample index (int64),
// draws the camera stream's four uniforms (slots 0-3 of depth CAMERA_STREAM,
// trace_common.cuh's bounce_base and uniform, in native uint32) and builds
// the ray of ops/camera.py:generate_camera_rays with its float32 operations
// in its order: x / (w - 1), (mid + (2 sx - 1) half_x) + (2 sy - 1) half_y,
// v / max(sqrt((x x + y y) + z z), 1e-12), and the thin-lens lines when the
// aperture is above 0.  It writes origin [N, 3] and direction [N, 3].  The
// per-camera constants (eye, mid, half_x, half_y, the unit basis and view,
// the focal distance, the aperture: ops/camera.py:camera_frame) are made on
// the device by the plain version's own torch ops, once for a camera
// (ops/camera.py:camera_table), and read from a small device table, so the
// host never waits for them.
//
// One rounding differs between PyTorch's two builds of the plain version:
// on a CUDA tensor, a float tensor divided by a Python number is computed
// as a product with the number's float32 reciprocal (PyTorch's
// div_true_kernel_cuda); on the CPU it is a division.  The kernel repeats
// the card's.
//
// What bounds it on the H100: bytes.  A lane reads 16 and writes 24, 40 B
// in all: 332 MB, 0.10 ms at 3.35 TB/s, for a 3840x2160 iteration.  The
// hash is about 40 integer operations a uniform and the ray about 60 float
// operations, far below the card's issue rate at that size.  The design is
// one thread a lane, blocks of 256, the 23-float table read through the
// read-only cache (46 registers, no spill).  Measured on an H100 80GB HBM3
// at 700 W: 0.122 ms of device time a launch at 8,294,400 lanes in the
// render benchmark's profile, against 10.74 ms for the plain ops' camera
// path (CUDA events) and the 0.099 ms bound.  Built with -fmad=false and
// without fast math, as every kernel of the port, so no a*b+c is contracted
// and sqrtf, sinf, cosf and the divisions are the correctly rounded (or
// libdevice) forms PyTorch's CUDA kernels call.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "trace_common.cuh"

namespace pt {

constexpr uint32_t CAMERA_STREAM = 0x10000;  // ops/rng.py: the camera draws' depth slot
// the per-camera table (the fields of ops/camera.py:CameraFrame): eye, mid,
// half_x, half_y, a_hat, b_hat, view_hat as 3 floats each, focal, aperture
constexpr int FRAME_COLS = 23;

// the float32 of pixel coordinate `v` over `extent - 1`, as PyTorch's
// `v / (extent - 1)` rounds on a CUDA tensor
PT_FN float pixel_scale(float v, long long extent) {
  return v * (1.0f / (float)(extent - 1));
}

// torch.clamp(min=1e-12): a NaN stays NaN
PT_FN float clamp_norm(float n) { return n < 1e-12f ? 1e-12f : n; }

PT_FN V3 normalize_div(V3 v) {
  const float n = clamp_norm(sqrtf(vdot(v, v)));
  return v3(v.x / n, v.y / n, v.z / n);
}

PT_FN V3 frame_vec(const float* f, int k) { return v3(f[3 * k], f[3 * k + 1], f[3 * k + 2]); }

// One lane: the primary ray of pixel `pixel` (x + y w) for the global sample
// `sample` (its uint32 bits key the hash), with jitter or not.
PT_FN void camera_lane(const float* f, uint32_t seed, long long pixel, long long sample,
                       long long w, long long h, int jitter, V3& origin, V3& direction) {
  const uint32_t base =
      bounce_base(seed, (uint32_t)(unsigned long long)sample * 0x85EBCA6Bu, (int)CAMERA_STREAM);
  const float u0 = uniform(base, 0), u1 = uniform(base, 1);
  const float u2 = uniform(base, 2), u3 = uniform(base, 3);

  // torch's floor division and modulo (the sign of the divisor)
  long long px = pixel % w;
  if (px != 0 && ((px < 0) != (w < 0))) px += w;
  const long long py = (pixel - px) / w;
  float x = (float)px, y = (float)py;
  if (jitter) {
    x = x + (u0 - 0.5f);
    y = y + (u1 - 0.5f);
  }
  const float sx = pixel_scale(x, w);
  const float sy = pixel_scale(y, h);

  const V3 eye = frame_vec(f, 0), mid = frame_vec(f, 1);
  const V3 half_x = frame_vec(f, 2), half_y = frame_vec(f, 3);
  const V3 point =
      vadd(vadd(mid, vscale(2.0f * sx - 1.0f, half_x)), vscale(2.0f * sy - 1.0f, half_y));
  const V3 dir = normalize_div(vsub(point, eye));
  const float focal = f[21], aperture = f[22];
  if (!(aperture > 0.0f)) {
    origin = eye;
    direction = dir;
    return;
  }
  // thin lens: a point on the aperture disc, aimed at the focal plane
  const float r = sqrtf(u2) * aperture;
  const float theta = TWO_PI * u3;
  const V3 lens = vadd(vscale(r * cosf(theta), frame_vec(f, 4)),
                       vscale(r * sinf(theta), frame_vec(f, 5)));
  const float cos_to_view = vdot(dir, frame_vec(f, 6));
  const V3 focus = vadd(eye, vscale(focal / cos_to_view, dir));
  origin = vadd(eye, lens);
  direction = normalize_div(vsub(focus, origin));
}

}  // namespace pt

#ifdef __CUDACC__

namespace {

using namespace pt;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
camera_kernel(const long long* __restrict__ pixel, const long long* __restrict__ sample, int n,
              const float* __restrict__ frame, uint32_t seed, long long w, long long h,
              int jitter, float* __restrict__ origin, float* __restrict__ direction) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)n) return;
  float f[FRAME_COLS];
#pragma unroll
  for (int k = 0; k < FRAME_COLS; ++k) f[k] = __ldg(frame + k);
  V3 o, d;
  camera_lane(f, seed, pixel[i], sample[i], w, h, jitter, o, d);
  origin[3 * i] = o.x;
  origin[3 * i + 1] = o.y;
  origin[3 * i + 2] = o.z;
  direction[3 * i] = d.x;
  direction[3 * i + 1] = d.y;
  direction[3 * i + 2] = d.z;
}

}  // namespace

// pixel, sample: [n] int64; frame: the [FRAME_COLS] per-camera table;
// origin, direction: [n, 3] float32
extern "C" int camera_launch(const long long* pixel, const long long* sample, int n,
                             const float* frame, unsigned int seed, long long w, long long h,
                             int jitter, float* origin, float* direction, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  camera_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(pixel, sample, n, frame, seed, w,
                                                               h, jitter, origin, direction);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
