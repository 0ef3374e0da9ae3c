// Kernel F — one event round of the narrow machinery: one thread a lane of
// the packed (16, E) event rows, absorbing at reservoirs (with their
// ledger), translating at periodic facets, reflecting at rough walls
// (specular Bernoulli against the Ziman specularity, the k model's
// degenerate swap, diffuse re-emission by Walker alias), re-casting the
// moved lanes against the box's walls and drifting every lane on. Python
// wrapper: nanokappa_torch/ops/event_round.py; its plain twin is the torch
// round itself (nanokappa_torch/sim/cascade.py `_event_round`), whose
// operations this kernel runs in the same order.
//
// It replaces no Pallas kernel: the JAX package runs these rounds as
// XLA-fused jnp code (nanokappa_tpu/sim/cascade.py run_event_buffer :283,
// _event_round :482). It exists because on the card the torch round is
// ~340 elementwise launches over a 2,048-lane buffer in which kernel A
// leaves 0-2 live lanes a step: the host's launches, not the device, set
// its time. What bounds the kernel: launch latency. Its bytes are the rows
// read and written once, 2,048 x 16 x 4 B x 2 = 0.26 MB (0.08 us at
// 3.35 TB/s), and its arithmetic a few hundred flops a live lane.
//
// `in` and `out` are one buffer in rounds 2+ (no __restrict__ on them).
//
// Round 1 (`first`) reads the input rows and writes every row of every lane
// of the output buffer (the input is left as it was), with the twin's
// round-1 state: t_coll 0, the facet and the remaining path of padding
// lanes (vbuf false) -1 and 0, and a lane whose C_TCOLL < -1.5 already won
// its specular Bernoulli in kernel A (`forced`). It also writes the pending
// mask that kernel C compacts into the rounds-2+ index vector. Rounds 2+
// run in place on the output buffer's lanes idx[k] (k < e; idx == stride
// is kernel C's sentinel and runs nothing), lane k taking the k-th row of
// the round's uniforms, as the twin's gathered buffer does. The `finish`
// launch quarantines the lanes still pending after k_max rounds (alive
// cleared, counted as stuck) and runs no physics.
//
// Sums: the ledger's per-block partials come from nk::block_segment_sums
// (thread order), and the last block to finish (an integer ticket) adds the
// blocks' partials in block order, in double, into the (R8, 5) ledger
// (round 1 writes it, later rounds add to it); the integer counts go the
// same way. No float atomics: the same inputs give the same bits. The
// ticket is zeroed when the scratch is made and by every launch's last
// block, so the scratch is left as it was found.
//
// Division by dt: torch divides a CUDA tensor by a Python float as a
// product with the float32 reciprocal, so the kernel does the same
// (`inv_dt`), and every other quotient is a true division, as the twin's.
#include <math.h>

#include "scan.cuh"

struct RoundCfg {  // mirrored by _RCfg in ops/event_round.py, field for field
  int e, stride, first, finish, n_facets, n_sv, linear, slice_axis;
  int n_modes, n_tau, r8, kmodel, evt2;
  float dt, inv_dt, t_ref, hbar, kb, lo, length, c0, dc;
  const float* facets;     // (n_facets, RF_W) [kind, res, pair, value, normal,
                           // shift, axis, sign, plane, row, back row], ints as bits
  const float* spec2;      // (rows, n_modes, 2) [specularity, partner bits]
  const float* diff2;      // (rows, n_modes, 2) [alias prob, alias mode bits]
  const int* degen;        // (n_modes,) equal-frequency partner branch or -1
  const float* omega_vel;  // (n_modes, 4)
  const float* tau;        // (n_tau, n_modes) lifetime table
  const float* tau_T;      // (n_tau,) its temperatures
};

namespace {

constexpr int C_OMEGA = 6, C_TAU = 7, C_DEV = 8, C_MODE = 9, C_CF = 10, C_TCOLL = 11,
              C_ONF = 12, C_REM = 13, C_ALIVE = 14, C_SV = 15;
// facet-table columns (ops/event_round.py RF_*)
constexpr int RF_KIND = 0, RF_RES = 1, RF_PAIR = 2, RF_VALUE = 3, RF_NORMAL = 4,
              RF_SHIFT = 7, RF_AXIS = 10, RF_SIGN = 11, RF_PLANE = 12, RF_ROW = 13,
              RF_ROWB = 14, RF_W = 16;
constexpr int K_ABSORB = 1, K_PERIODIC = 2, K_ROUGH = 3;
constexpr float REMAIN_EPS = 1e-5f;
constexpr float T_BACK = -1e-4f;
constexpr float X_MAX = 80.0f;

// NaN-propagating torch.minimum and torch.clamp(min=lo)
__device__ __forceinline__ float min_p(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float max_p(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// sim/bose.py _expm1_x: expm1(hbar omega / (kB T)), masked where T <= 0 or
// omega <= 0
__device__ __forceinline__ float expm1_x(float T, float omega, bool* ok, const RoundCfg& c) {
  *ok = (T > 0.0f) && (omega > 0.0f);
  float x = *ok ? (omega * c.hbar) / ((*ok ? T : 1.0f) * c.kb) : 1.0f;
  x = x > X_MAX ? X_MAX : x;
  return expm1f(x);
}

// sim/bose.py occupation_delta_T: n0(T, omega) - n0(T_ref, omega)
__device__ __forceinline__ float occ_T(float T, float omega, const RoundCfg& c) {
  bool okT, okR;
  const float eT = expm1_x(T, omega, &okT, c);
  const float eR = expm1_x(c.t_ref, omega, &okR, c);
  const float nT = okT ? 1.0f / eT : 0.0f;
  const float nR = okR ? 1.0f / eR : 0.0f;
  return (okT && okR) ? (eR - eT) / (eT * eR) : nT - nR;
}

// sim/bose.py occupation_delta_omega: n0(T_ref, a) - n0(T_ref, b)
__device__ __forceinline__ float occ_omega(float a, float b, const RoundCfg& c) {
  bool okA, okB;
  const float eA = expm1_x(c.t_ref, a, &okA, c);
  const float eB = expm1_x(c.t_ref, b, &okB, c);
  const float nA = okA ? 1.0f / eA : 0.0f;
  const float nB = okB ? 1.0f / eB : 0.0f;
  return (okA && okB) ? (eB - eA) / (eA * eB) : nA - nB;
}

// sim/binning.py subvol_id on slices: floor((x - lo) / length), clamped
__device__ __forceinline__ int slice_of(float x, const RoundCfg& c) {
  const int i = (int)floorf((x - c.lo) / c.length);
  return i < 0 ? 0 : (i > c.n_sv - 1 ? c.n_sv - 1 : i);
}

// sim/binning.py interp_T_particles: T_sv of the slice, or (linear) the
// lerp between the slice centres around x, extrapolated past the end ones
__device__ __forceinline__ float T_at(float x, int sv, const RoundCfg& c,
                                      const float* __restrict__ T_sv) {
  if (c.linear) {
    const float fpos = (x - c.c0) / c.dc;
    int lo = (int)fpos;
    lo = lo < 0 ? 0 : (lo > c.n_sv - 2 ? c.n_sv - 2 : lo);
    if (fpos < 0.0f) lo = 0;
    const float w = fpos - (float)lo;
    return T_sv[lo] * (1.0f - w) + T_sv[lo + 1] * w;
  }
  return T_sv[sv];
}

// sim/scatter.py: the lifetime table's T-lerp at T (lifetime_lookup, and
// blend_tau_sv per element for the nearest temperatures)
__device__ __forceinline__ float tau_at(float T, int m, const RoundCfg& c) {
  const int nT = c.n_tau;
  int cnt = 0;  // searchsorted(tau_T, T, side="left")
  for (int k = 0; k < nT; ++k) cnt += c.tau_T[k] < T ? 1 : 0;
  const int top = nT - 2 > 0 ? nT - 2 : 0;
  int i = cnt - 1;
  i = i < 0 ? 0 : (i > top ? top : i);
  const int hi = i + 1 > nT - 1 ? nT - 1 : i + 1;
  float w = (T - c.tau_T[i]) / max_p(c.tau_T[hi] - c.tau_T[i], 1e-30f);
  w = w < 0.0f ? 0.0f : (w > 1.0f ? 1.0f : w);
  return c.tau[(size_t)i * c.n_modes + m] * (1.0f - w) + c.tau[(size_t)hi * c.n_modes + m] * w;
}

// ops/raycast.py _raycast_box: the slab cast against every wall of the
// box, skipping facet `exclude`
__device__ __forceinline__ void box_cast(const float p[3], const float v[3], int exclude,
                                         const RoundCfg& c, float* t_out, int* f_out) {
  float best_t = INFINITY;
  int best_f = -1;
  for (int f = 0; f < c.n_facets; ++f) {
    const float* r = c.facets + f * RF_W;
    const int a = __float_as_int(r[RF_AXIS]);
    const float va = a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
    const float pa = a == 0 ? p[0] : (a == 1 ? p[1] : p[2]);
    const bool toward = va * r[RF_SIGN] > 0.0f;
    const float t_raw = (r[RF_PLANE] - pa) / (fabsf(va) > 1e-30f ? va : 1e-30f);
    const float t = clamp_min(t_raw, 0.0f);
    if (toward && t_raw > T_BACK && t < best_t && exclude != f) {
      best_t = t;
      best_f = f;
    }
  }
  *t_out = best_t;
  *f_out = best_f;
}

// the last block to finish adds the blocks' partials in block order:
// the ledger (part: R8 * 5 outputs, nb each) and the counts (blk: nb
// [pending, defective, swaps, stuck] rows)
__device__ void finish_sums(const RoundCfg& c, int nb, const float* __restrict__ part,
                            const int* __restrict__ blk, float* __restrict__ ledger,
                            long long* __restrict__ acc) {
  int* cnt = reinterpret_cast<int*>(acc + 1);  // [pending, defective, stuck, frozen]
  const int t = threadIdx.x;
  if (!c.finish && t < c.r8 * 5) {
    double s = 0.0;
    for (int b = 0; b < nb; ++b) s += (double)__ldcg(part + (size_t)t * nb + b);
    ledger[t] = c.first ? (float)s : ledger[t] + (float)s;
  }
  if (t == 0) {
    long long n[4] = {0, 0, 0, 0};
    for (int k = 0; k < 4; ++k)
      for (int b = 0; b < nb; ++b) n[k] += __ldcg(blk + (size_t)k * nb + b);
    cnt[0] = (int)n[0];
    if (c.finish) {
      cnt[2] = (int)n[3];
    } else if (c.first) {
      cnt[1] = (int)n[1];
      cnt[2] = 0;
      cnt[3] = n[0] > c.evt2 ? (int)(n[0] - c.evt2) : 0;
      acc[0] = n[2];
    } else {
      cnt[1] += (int)n[1];
      acc[0] += n[2];
    }
  }
}

__global__ void __launch_bounds__(NK_BLOCK)
event_round(const RoundCfg c, const float* in, float* out,
            const uint8_t* __restrict__ vbuf, const int* __restrict__ idx,
            const float* __restrict__ u4, const float* __restrict__ T_sv,
            uint8_t* __restrict__ pend_mask, float* __restrict__ ledger,
            long long* __restrict__ acc, float* __restrict__ part, int* __restrict__ blk,
            int* __restrict__ ticket) {
  const int nb = gridDim.x;
  const int k = blockIdx.x * NK_BLOCK + threadIdx.x;
  const int S = c.stride;
  const int j = k < c.e ? (c.first ? k : idx[k]) : S;  // this lane's buffer column
  const bool live = j < S;
  auto rin = [&](int r) { return in[(size_t)r * S + j]; };
  auto rout = [&](int r) -> float& { return out[(size_t)r * S + j]; };

  int seg = -1, n_bad = 0, n_swap = 0, n_stuck = 0;
  bool pend = false;
  float vals[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (live && c.finish) {
    // quarantine: a lane still pending after k_max rounds leaves dead
    pend = rout(C_ALIVE) > 0.5f && rout(C_REM) > REMAIN_EPS;
    if (pend) rout(C_ALIVE) = 0.0f;
    n_stuck = pend ? 1 : 0;
    pend = false;
  } else if (live) {
    float p[3] = {rin(0), rin(1), rin(2)};
    float v[3] = {rin(3), rin(4), rin(5)};
    const float omega = rin(C_OMEGA), tau = rin(C_TAU), dev = rin(C_DEV);
    const int mode = __float_as_int(rin(C_MODE));
    int onf = __float_as_int(rin(C_ONF));
    int cf = __float_as_int(rin(C_CF));
    float t_coll, rem;
    bool alive, forced = false;
    if (c.first) {
      alive = vbuf[j] != 0;
      forced = alive && rin(C_TCOLL) < -1.5f;
      t_coll = 0.0f;
      cf = alive ? cf : -1;
      rem = alive ? rin(C_REM) : 0.0f;
    } else {
      alive = rin(C_ALIVE) > 0.5f;
      t_coll = rin(C_TCOLL);
      rem = rin(C_REM);
    }
    const float* fr = c.facets + (cf < 0 ? 0 : (cf > c.n_facets - 1 ? c.n_facets - 1 : cf)) * RF_W;
    const int cfc = cf < 0 ? 0 : (cf > c.n_facets - 1 ? c.n_facets - 1 : cf);
    const int kind = __float_as_int(fr[RF_KIND]);
    const bool at_wall = alive && rem > REMAIN_EPS && t_coll <= 1e-9f && cf >= 0;
    const float vdn = (v[0] * fr[RF_NORMAL] + v[1] * fr[RF_NORMAL + 1]) + v[2] * fr[RF_NORMAL + 2];

    // --- absorption at reservoirs, into the ledger ---------------------------
    const bool absorb = at_wall && kind == K_ABSORB;
    if (absorb) {
      const float dn_abs = dev - occ_T(fr[RF_VALUE], omega, c);
      const float e_abs = (c.hbar * omega) * dn_abs;
      const float vmag = sqrtf((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
      const float sgn = vdn > 0.0f ? 1.0f : (vdn < 0.0f ? -1.0f : 0.0f);
      const float vdn_safe = sgn * max_p(fabsf(vdn), 1e-3f * vmag);
      const float fw = fabsf(vdn_safe) > 1e-30f ? e_abs / vdn_safe : 0.0f;
      const int res = __float_as_int(fr[RF_RES]);
      seg = res >= 0 ? res : c.r8 - 1;
      vals[0] = e_abs;
      vals[1] = fw * v[0];
      vals[2] = fw * v[1];
      vals[3] = fw * v[2];
      vals[4] = 1.0f;
    }
    alive = alive && !absorb;
    rem = absorb ? 0.0f : rem;

    // --- periodic translation ---------------------------------------------------
    const bool per = at_wall && kind == K_PERIODIC;
    const float w_per = per ? 1.0f : 0.0f;
    for (int a = 0; a < 3; ++a) p[a] = p[a] + w_per * fr[RF_SHIFT + a];
    if (per) onf = __float_as_int(fr[RF_PAIR]);

    // --- rough-wall reflection --------------------------------------------------
    const bool ref = at_wall && kind == K_ROUGH;
    const int M = c.n_modes;
    int mode_new = mode;
    float omega_new = omega, tau_new = tau, dev_new = dev;
    float vn[3] = {v[0], v[1], v[2]};
    if (ref) {
      // a back-side hit (velocity against the stored normal) takes the row
      // built for the flipped normal
      const int row = __float_as_int(vdn < 0.0f ? fr[RF_ROWB] : fr[RF_ROW]);
      const float2 sc = reinterpret_cast<const float2*>(c.spec2)[(size_t)row * M + mode];
      const int corr = __float_as_int(sc.y);
      const float* u = u4 + (size_t)k * 4;
      const bool spec = ((u[0] <= sc.x) || forced) && corr >= 0;
      int jj = (int)(u[1] * (float)M);
      jj = jj > M - 1 ? M - 1 : jj;
      const float2 pa = reinterpret_cast<const float2*>(c.diff2)[(size_t)row * M + jj];
      const int mode_diff = u[2] < pa.x ? jj : __float_as_int(pa.y);
      int mode_spec = corr;
      if (c.kmodel && spec) {
        // the k model's degenerate-branch split: a specular lane swaps to
        // its equal-frequency partner branch with probability 1/2
        const int partner = c.degen[mode_spec < 0 ? 0 : (mode_spec > M - 1 ? M - 1 : mode_spec)];
        if (partner >= 0 && u[3] >= 0.5f) {
          mode_spec = partner;
          n_swap = 1;
        }
      }
      mode_new = spec ? mode_spec : mode_diff;
      const float4 ov = reinterpret_cast<const float4*>(c.omega_vel)[mode_new];
      omega_new = ov.x;
      vn[0] = ov.y;
      vn[1] = ov.z;
      vn[2] = ov.w;
      const float xs = p[c.slice_axis == 0 ? 0 : (c.slice_axis == 1 ? 1 : 2)];
      const int sv = slice_of(xs, c);
      const float T_wall = T_at(xs, sv, c, T_sv);
      tau_new = tau_at(T_wall, mode_new, c);
      dev_new = spec ? dev + occ_omega(omega, omega_new, c) : occ_T(T_wall, omega_new, c);
      onf = cfc;
    }

    // --- re-cast the moved lanes, drift every lane ------------------------------
    if (per || ref) {
      float tb;
      int fb;
      box_cast(p, vn, onf, c, &tb, &fb);
      t_coll = tb * c.inv_dt;
      cf = fb;
    }
    float sf = (alive && rem > 0.0f) ? min_p(t_coll, rem) : 0.0f;
    sf = isfinite(sf) ? sf : rem;
    for (int a = 0; a < 3; ++a) p[a] = p[a] + vn[a] * (c.dt * sf);
    t_coll = t_coll - sf;
    rem = clamp_min(rem - sf, 0.0f);
    // defective lanes (no boundary found) drain
    const bool bad = alive && rem > REMAIN_EPS && cf < 0;
    alive = alive && !bad;
    rem = bad ? 0.0f : rem;
    n_bad = bad ? 1 : 0;
    pend = alive && rem > REMAIN_EPS;

    for (int a = 0; a < 3; ++a) {
      rout(a) = p[a];
      rout(3 + a) = vn[a];
    }
    rout(C_OMEGA) = omega_new;
    rout(C_TAU) = tau_new;
    rout(C_DEV) = dev_new;
    rout(C_MODE) = __int_as_float(mode_new);
    rout(C_CF) = __int_as_float(cf);
    rout(C_TCOLL) = t_coll;
    rout(C_ONF) = __int_as_float(onf);
    rout(C_REM) = rem;
    rout(C_ALIVE) = alive ? 1.0f : 0.0f;
    if (c.first) {
      rout(C_SV) = rin(C_SV);
      pend_mask[j] = pend ? 1 : 0;
    }
  }

  // --- per-block sums, then the last block's fixed-order total --------------------
  if (!c.finish) nk::block_segment_sums(seg, vals, c.r8, part, nb);
  __threadfence();  // this thread's partials and rows, before the ticket
  const int counts[4] = {__syncthreads_count(pend), __syncthreads_count(n_bad),
                         __syncthreads_count(n_swap), __syncthreads_count(n_stuck)};
  __shared__ bool last;
  if (threadIdx.x == 0) {
    for (int q = 0; q < 4; ++q) blk[(size_t)q * nb + blockIdx.x] = counts[q];
    __threadfence();
    last = atomicAdd(ticket, 1) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish_sums(c, nb, part, blk, ledger, acc);
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace

// One launch: round 1 (first), a round 2+ in place (idx), or the k_max
// quarantine (finish). acc: (3,) int64 [swaps, then the int32 counts
// pending, defective, stuck, frozen]. part: nb * r8 * 5 floats (r8 * 5 <=
// NK_BLOCK: the last block's threads add one output each), blk: 4 * nb
// ints, ticket: one int, zero on entry and on exit (nb = ceil(e / 256)).
extern "C" int nk_event_round(const void* cfg, const void* in, void* out, const void* vbuf,
                              const void* idx, const void* u4, const void* T_sv, void* pend,
                              void* ledger, void* acc, void* part, void* blk, void* ticket,
                              void* stream) {
  const RoundCfg c = *static_cast<const RoundCfg*>(cfg);
  if (c.e <= 0 || c.r8 * 5 > NK_BLOCK || c.n_facets <= 0 || c.n_sv <= 0 ||
      (c.linear && c.n_sv < 2) || (!c.first && idx == nullptr) ||
      (c.first && (vbuf == nullptr || pend == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (c.e + NK_BLOCK - 1) / NK_BLOCK;
  event_round<<<nb, NK_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const float*>(in), static_cast<float*>(out),
      static_cast<const uint8_t*>(vbuf), static_cast<const int*>(idx),
      static_cast<const float*>(u4), static_cast<const float*>(T_sv),
      static_cast<uint8_t*>(pend), static_cast<float*>(ledger), static_cast<long long*>(acc),
      static_cast<float*>(part), static_cast<int*>(blk), static_cast<int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
