// Native host-side runtime for local_search_quantization.
//
// The framework keeps the *compute* path on the accelerator (XLA);
// this library is the host data plane, replacing the reference's native
// layer (/root/reference/src/linscan/cpp/linscan_aqd.cpp,
// linscan_aqd_pairwise_byte.cpp and the src/read/ Julia readers):
//
//  - lsq_linscan: OpenMP ADC lookup-table kNN scan over byte codes, for
//    query serving from CPU hosts (and as a reference oracle for the
//    device scanner). Unlike the reference it takes precomputed per-query LUTs so
//    one entry point covers PQ/OPQ (distance LUTs) and additive codes
//    (inner-product LUTs + norm term).
//  - lsq_vecs_read: bulk TEXMEX fvecs/ivecs/bvecs reader with per-record
//    dimension validation, used by utils/io.py as a fast path.
//
// Build: make -C native     (g++ -O3 -fopenmp -shared)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
#include <immintrin.h>
#define LSQ_HAVE_VBMI 1
#endif

namespace {

// Phase-1 ADC fill for a block of NB rows: buf[i] = sum_j lut_j[code[i,j]].
// The naive per-row loop is bound by its single dependent L1-load-add chain
// (~load latency per term, not load throughput); eight independent row
// chains keep ~8 loads in flight and approach the 2-loads/cycle L1 limit.
// Templated on M so the inner loop fully unrolls at the common widths.
template <int M>
void adc_block(float* buf, const uint8_t* c, const float* lut, int nb,
               int m_rt, int h) {
  const int m = (M > 0) ? M : m_rt;
  int i = 0;
  for (; i + 8 <= nb; i += 8, c += (int64_t)8 * m) {
    float d0 = 0, d1 = 0, d2 = 0, d3 = 0, d4 = 0, d5 = 0, d6 = 0, d7 = 0;
    for (int j = 0; j < m; ++j) {
      const float* l = lut + (int64_t)j * h;
      d0 += l[c[j]];
      d1 += l[c[m + j]];
      d2 += l[c[2 * m + j]];
      d3 += l[c[3 * m + j]];
      d4 += l[c[4 * m + j]];
      d5 += l[c[5 * m + j]];
      d6 += l[c[6 * m + j]];
      d7 += l[c[7 * m + j]];
    }
    buf[i] = d0; buf[i + 1] = d1; buf[i + 2] = d2; buf[i + 3] = d3;
    buf[i + 4] = d4; buf[i + 5] = d5; buf[i + 6] = d6; buf[i + 7] = d7;
  }
  for (; i < nb; ++i, c += m) {
    float d = 0;
    for (int j = 0; j < m; ++j) d += lut[(int64_t)j * h + c[j]];
    buf[i] = d;
  }
}

using HeapVec = std::vector<std::pair<float, int64_t>>;

// Streaming size-k max-heap insert; returns the (possibly tightened)
// k-th-best threshold. Shared by every scanner so accept order — and
// therefore tie resolution — is identical across paths.
inline float heap_insert(HeapVec& heap, int64_t k, float thresh, float d,
                         int64_t id) {
  if ((int64_t)heap.size() < k) {
    heap.emplace_back(d, id);
    std::push_heap(heap.begin(), heap.end());
    if ((int64_t)heap.size() == k) return heap.front().first;
    return thresh;
  }
  std::pop_heap(heap.begin(), heap.end());
  heap.back() = {d, id};
  std::push_heap(heap.begin(), heap.end());
  return heap.front().first;
}

// Append-buffer top-k: the streaming heap's accept set is exactly the
// lexicographic-(dist, id) top-k (strict `d < thresh` keeps the earliest
// = smallest-id row among k-th-distance ties), so an append + periodic
// nth_element computes the SAME result at ~O(1) predictable work per
// candidate where every heap insert costs ~2 log k unpredictable branches.
// Used by the SIMD scanner; lsq_linscan keeps the heap as an independent
// oracle implementation.
struct TopK {
  std::vector<std::pair<float, int64_t>> buf;
  int64_t k = 0;
  size_t cap = 0;
  bool use_heap = true;
  float thresh = std::numeric_limits<float>::infinity();
  void init(int64_t k_, bool heap_mode) {
    k = k_;
    use_heap = heap_mode;
    cap = (size_t)(2 * k_);
    buf.reserve((use_heap ? (size_t)k : cap) + 64);
  }
  void rebuild() {
    if (use_heap) return;  // heap mode keeps thresh exact per accept
    if ((int64_t)buf.size() > k) {
      std::nth_element(buf.begin(), buf.begin() + (k - 1), buf.end());
      buf.resize(k);
      thresh = buf[k - 1].first;  // nth_element left the k-th best there
    } else if ((int64_t)buf.size() == (int64_t)k) {
      // Never exceeded k, so buf is UNSORTED: the threshold is the worst
      // kept element, not whatever sits at slot k-1.
      thresh = std::max_element(buf.begin(), buf.end())->first;
    }
  }
  inline void add(float d, int64_t id) {
    if (use_heap) {
      thresh = heap_insert(buf, k, thresh, d, id);
      return;
    }
    buf.emplace_back(d, id);
    if (buf.size() >= cap) rebuild();
  }
  void finish() {
    if (use_heap) {
      std::sort_heap(buf.begin(), buf.end());
    } else {
      rebuild();
      std::sort(buf.begin(), buf.end());
    }
  }
};

// Streaming-heap sink: thresh tightens after every accept. Kept as the
// independent oracle candidate-set next to TopK's append-buffer mode.
struct HeapSink {
  HeapVec& heap;
  int64_t k;
  float thresh = std::numeric_limits<float>::infinity();
  inline void add(float d, int64_t id) {
    thresh = heap_insert(heap, k, thresh, d, id);
  }
};

// Blocked exact scalar scan of rows [row0, row1) (the original two-phase
// loop): used whole by lsq_linscan (HeapSink) and as prologue/tail by the
// SIMD path (TopK). Sink needs `.thresh` and `.add(dist, id)`; ONE shared
// loop keeps the two paths' accept sequences bit-identical by construction.
template <typename Fill, typename Sink>
void scan_range_exact(Fill fill, const float* extra, Sink& sink,
                      int64_t row0, int64_t row1, const uint8_t* codes,
                      const float* lut, int m, int h) {
  constexpr int BS = 4096;
  float buf[BS];
  for (int64_t r0 = row0; r0 < row1; r0 += BS) {
    const int nb = (int)std::min<int64_t>(BS, row1 - r0);
    fill(buf, codes + r0 * (int64_t)m, lut, nb, m, h);
    if (extra) {
      const float* e = extra + r0;
      for (int i = 0; i < nb; ++i) buf[i] += e[i];
    }
    for (int i = 0; i < nb; ++i) {
      if (buf[i] < sink.thresh) sink.add(buf[i], r0 + i);
    }
  }
}

}  // namespace

extern "C" {

// ADC scan: for each query q, dist[i] = sum_j luts[q, j, codes[i, j]]
// (+ extra[i] if extra != nullptr), return the k smallest with indices.
//
//   dists : out [nq, k] float32
//   ids   : out [nq, k] int64 (0-based)
//   codes : in  [n, m] uint8 row-major
//   luts  : in  [nq, m, h] float32
//   extra : in  [n] float32 or nullptr (quantized database norms)
//   returns 0 on success.
int lsq_linscan(float* dists, int64_t* ids, const uint8_t* codes,
                const float* luts, const float* extra, int64_t n, int64_t nq,
                int m, int h, int k) {
  if (k > n || m <= 0 || h <= 0 || k <= 0) return 1;
  auto fill = adc_block<0>;
  if (m == 7) fill = adc_block<7>;
  if (m == 8) fill = adc_block<8>;
  if (m == 15) fill = adc_block<15>;
  if (m == 16) fill = adc_block<16>;

#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t q = 0; q < nq; ++q) {
    const float* lut = luts + q * (int64_t)m * h;
    // Max-heap of size k over (dist, id): top is the current k-th best.
    // Phase 2 inside scan_range_exact is a single predictable compare per
    // row (expected pass count over the db ~ k * (1 + ln(n/k))).
    HeapVec heap;
    heap.reserve(k + 1);
    HeapSink sink{heap, k};
    scan_range_exact(fill, extra, sink, 0, n, codes, lut, m, h);
    std::sort_heap(heap.begin(), heap.end());
    float* dq = dists + q * (int64_t)k;
    int64_t* iq = ids + q * (int64_t)k;
    // +inf rows (e.g. tombstoned entries served via extra) are never
    // accepted, so fewer than k candidates can survive; pad with the
    // (+inf, -1) sentinel the sharded-query merge also uses.
    const int64_t got = (int64_t)heap.size();
    for (int64_t j = 0; j < k; ++j) {
      dq[j] = j < got ? heap[j].first : std::numeric_limits<float>::infinity();
      iq[j] = j < got ? heap[j].second : -1;
    }
  }
  return 0;
}

// SIMD ADC scan (AVX-512 VBMI): same contract and BIT-IDENTICAL results as
// lsq_linscan, ~an order of magnitude past its L1-load-port bound.
//
// The scalar scanner's phase-1 fill is bound by L1 load throughput (2
// lookups/cycle); hardware gathers retire at the same port limit. This
// entry breaks the wall by moving the lookup tables INTO REGISTERS: each
// per-query LUT row is floor-quantized to u8 (shared global scale s =
// 255 / max per-(query,codebook) span), so a 256-entry lookup for 64 rows
// is two vpermt2b (128-byte in-register tables) + a sign-bit blend — ~10+
// lookups/cycle. The u16 sum of quantized entries (+ the once-quantized
// norm term) is a certified LOWER BOUND on the true distance: a row is
// pruned only when even its lower bound cannot beat the current k-th-best
// threshold, and every surviving candidate is re-checked in exact f32
// through the same heap_insert as the scalar path — identical accept
// sequence, identical ties, identical output.
//
// Returns 0 on success, 1 on bad args, 2 when compiled without AVX-512
// VBMI or m > 32 (caller falls back to lsq_linscan).
int lsq_linscan_fast(float* dists, int64_t* ids, const uint8_t* codes,
                     const float* luts, const float* extra, int64_t n,
                     int64_t nq, int m, int h, int k) {
#ifndef LSQ_HAVE_VBMI
  (void)dists; (void)ids; (void)codes; (void)luts; (void)extra;
  (void)n; (void)nq; (void)m; (void)h; (void)k;
  return 2;
#else
  if (k > n || m <= 0 || h <= 0 || k <= 0) return 1;
  if (m > 32) return 2;  // u16 accumulator headroom (255*m + norm term)
  const int hc = h < 256 ? h : 256;  // uint8 codes reach at most entry 255

  auto fill = adc_block<0>;
  if (m == 7) fill = adc_block<7>;
  if (m == 8) fill = adc_block<8>;
  if (m == 15) fill = adc_block<15>;
  if (m == 16) fill = adc_block<16>;

  // Candidate-set maintenance: the streaming heap tightens the pruning
  // threshold after EVERY accept (tightest SIMD band — wins at small k,
  // where inserts are rare and cheap); the append buffer + periodic
  // nth_element costs ~O(1) predictable work per candidate (wins at large
  // k, where ~k ln(n/k) heap inserts of ~2 log k mispredicted branches
  // dominate). Both produce the lexicographic-(dist, id) top-k exactly.
  bool heap_mode = k <= 256;
  if (const char* e = std::getenv("LSQ_NATIVE_TOPK")) {
    if (std::strcmp(e, "heap") == 0) heap_mode = true;
    if (std::strcmp(e, "buf") == 0) heap_mode = false;
  }

  // One u8 step = (max LUT span over all queries AND codebooks) / 255,
  // shared by every query so the db-norm term quantizes ONCE for the call.
  std::vector<float> lut_min((size_t)nq * m);
  double max_span = 0.0;
  for (int64_t qj = 0; qj < nq * (int64_t)m; ++qj) {
    const float* l = luts + qj * (int64_t)h;
    float lo = l[0], hi = l[0];
    for (int v = 1; v < hc; ++v) {
      lo = std::min(lo, l[v]);
      hi = std::max(hi, l[v]);
    }
    lut_min[qj] = lo;
    max_span = std::max(max_span, (double)hi - (double)lo);
  }
  const double s = max_span > 0 ? 255.0 / max_span : 0.0;

  // Column-major code planes: the 64 consecutive rows of one codebook are
  // one contiguous zmm load (the device path stores codes [m, n] for the
  // same reason — see ops/adc.py).
  const int64_t n64 = (n + 63) & ~int64_t{63};
  std::vector<uint8_t> codesT((size_t)m * n64, 0);
  for (int64_t i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) codesT[(size_t)j * n64 + i] = codes[i * m + j];

  // Norm term, floor-quantized once (query-independent); the cap keeps the
  // u16 sum overflow-free and, like floor, only LOWERS the bound.
  float emin = 0.f;
  std::vector<uint16_t> eq;
  if (extra) {
    emin = extra[0];
    for (int64_t i = 1; i < n; ++i) emin = std::min(emin, extra[i]);
    const double cap = 65535.0 - 255.0 * m;
    eq.resize((size_t)n64, 0);
    for (int64_t i = 0; i < n; ++i) {
      double v = ((double)extra[i] - (double)emin) * s;
      eq[i] = (uint16_t)(v <= 0 ? 0 : (v >= cap ? cap : v));
    }
  }

#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t q = 0; q < nq; ++q) {
    const float* lut = luts + q * (int64_t)m * h;
    alignas(64) uint8_t tbl[32][256];
    double offq = extra ? (double)emin : 0.0;
    for (int j = 0; j < m; ++j) {
      const float mn = lut_min[q * m + j];
      offq += (double)mn;
      for (int v = 0; v < hc; ++v) {
        const double t = ((double)lut[(int64_t)j * h + v] - (double)mn) * s;
        tbl[j][v] = (uint8_t)(t >= 255.0 ? 255 : (t <= 0 ? 0 : (int)t));
      }
      for (int v = hc; v < 256; ++v) tbl[j][v] = 255;
    }

    TopK tk;
    tk.init(k, heap_mode);
    // Prologue: exact scan until the buffer holds k rows (every one of the
    // first k rows is accepted regardless — pruning can't start before
    // then); the rebuild sets the pruning threshold.
    const int64_t ka = std::min<int64_t>(n, (k + 63) & ~int64_t{63});
    scan_range_exact(fill, extra, tk, 0, ka, codes, lut, m, h);
    tk.rebuild();

    const int64_t nfull = ka + ((n - ka) & ~int64_t{63});
    for (int64_t r = ka; r < nfull; r += 64) {
      // Quantized threshold for this chunk. +m+2 absorbs the double-
      // rounding slop of the m+1 floor quantizations, so sum < tq is
      // implied by d < thresh — pruning is provably safe; the handful of
      // extra candidates inside the slop band are exact-filtered below.
      const double td = ((double)tk.thresh - offq) * s;
      bool take_all = false;
      uint32_t tq = 0;
      if (!((double)tk.thresh > offq)) {
        continue;  // thresh <= offq = min possible distance: nothing beats it
      } else if (s == 0.0 || td >= 65532.0 - m) {
        // Zero LUT span (s == 0: every quantized sum is 0) or a threshold
        // beyond the u16 range: the compare proves nothing — keep all rows.
        take_all = true;
      } else {
        tq = (uint32_t)td + (uint32_t)m + 2;
      }

      __m512i sum_lo, sum_hi;
      if (extra) {
        sum_lo = _mm512_loadu_si512((const void*)(eq.data() + r));
        sum_hi = _mm512_loadu_si512((const void*)(eq.data() + r + 32));
      } else {
        sum_lo = _mm512_setzero_si512();
        sum_hi = _mm512_setzero_si512();
      }
      for (int j = 0; j < m; ++j) {
        const __m512i t0 = _mm512_load_si512((const void*)tbl[j]);
        const __m512i t1 = _mm512_load_si512((const void*)(tbl[j] + 64));
        const __m512i t2 = _mm512_load_si512((const void*)(tbl[j] + 128));
        const __m512i t3 = _mm512_load_si512((const void*)(tbl[j] + 192));
        const __m512i idx = _mm512_loadu_si512(
            (const void*)(codesT.data() + (size_t)j * n64 + r));
        const __m512i rlo = _mm512_permutex2var_epi8(t0, idx, t1);
        const __m512i rhi = _mm512_permutex2var_epi8(t2, idx, t3);
        const __mmask64 top = _mm512_movepi8_mask(idx);  // code bit 7
        const __m512i res = _mm512_mask_blend_epi8(top, rlo, rhi);
        sum_lo = _mm512_add_epi16(
            sum_lo, _mm512_cvtepu8_epi16(_mm512_castsi512_si256(res)));
        sum_hi = _mm512_add_epi16(
            sum_hi,
            _mm512_cvtepu8_epi16(_mm512_extracti64x4_epi64(res, 1)));
      }
      uint32_t mlo, mhi;
      if (take_all) {
        mlo = mhi = 0xFFFFFFFFu;
      } else {
        const __m512i tqv = _mm512_set1_epi16((short)(uint16_t)tq);
        mlo = (uint32_t)_mm512_cmplt_epu16_mask(sum_lo, tqv);
        mhi = (uint32_t)_mm512_cmplt_epu16_mask(sum_hi, tqv);
      }
      // Candidates in ascending row order (lo half, then hi) so the heap
      // evolves exactly as the scalar scan's.
      while (mlo | mhi) {
        int64_t row;
        if (mlo) {
          row = r + __builtin_ctz(mlo);
          mlo &= mlo - 1;
        } else {
          row = r + 32 + __builtin_ctz(mhi);
          mhi &= mhi - 1;
        }
        // Exact re-check reads the TRANSPOSED planes — this chunk's bytes
        // were just loaded into zmm, so they are L1-hot, where the
        // row-major codes would be a cold cache miss per sparse candidate.
        // FP addition order matches adc_block (LUT terms ascending, THEN
        // the norm term): distances are bit-identical to the scalar path.
        float d = 0.f;
        for (int j = 0; j < m; ++j)
          d += lut[(int64_t)j * h + codesT[(size_t)j * n64 + row]];
        if (extra) d += extra[row];
        if (d < tk.thresh) tk.add(d, row);
      }
    }
    // Tail rows past the last full 64-chunk: exact scalar.
    scan_range_exact(fill, extra, tk, nfull, n, codes, lut, m, h);

    tk.finish();
    float* dq = dists + q * (int64_t)k;
    int64_t* iq = ids + q * (int64_t)k;
    const int64_t got = (int64_t)tk.buf.size();
    for (int64_t j = 0; j < k; ++j) {
      dq[j] = j < got ? tk.buf[j].first
                      : std::numeric_limits<float>::infinity();
      iq[j] = j < got ? tk.buf[j].second : -1;
    }
  }
  return 0;
#endif
}

// IVF-ADC scan: probe only the coarse lists named per query, scanning
// their contiguous row segments of a grouped code store. Beyond the
// reference (whose scanners are exhaustive, linscan_aqd.cpp:37-102): this
// is the standard production serving path — candidate work drops by
// ~nlist/nprobe at a recall cost set by the coarse quantizer.
//
//   dists/ids : out [nq, k]; short result sets pad with (+inf, -1).
//   codes_g   : in [n_g, m] u8 row-major, rows grouped by list (scalar path)
//   codesT_g  : in [m, n_g] u8 plane-major (VBMI path), or nullptr to
//               force the scalar path
//   luts      : in [nq, m, h] f32
//   extra_g   : in [n_g] f32 grouped norm terms / +inf tombstones, or null
//   order     : in [n_g] int64 original row ids (pad rows hold -1; pads are
//               excluded by `lives`, never scanned or emitted)
//   starts    : in [nlist+1] int64 padded segment offsets, 64-aligned
//   lives     : in [nlist] int64 live (unpadded) rows per segment
//   probes    : in [nq, nprobe] int32 list ids, -1 = unused slot; a query's
//               probe slots must be distinct (duplicates would duplicate
//               candidates)
//   emin      : lower bound of the finite extra_g values (0 when null) —
//               computed once at partition build; deletes only raise the
//               true minimum, so a stale bound stays valid.
//
// Results are exact over the probed segments: quantized sums only PRUNE
// (certified lower bound, same argument as lsq_linscan_fast); accepts are
// exact f32 through the same TopK. Ties at the k-th boundary resolve by
// probe order (the exhaustive scanners resolve by row order).
// Returns 0 ok, 1 bad args.
int lsq_linscan_ivf(float* dists, int64_t* ids_out, const uint8_t* codes_g,
                    const uint8_t* codesT_g, const float* luts,
                    const float* extra_g, const int64_t* order,
                    const int64_t* starts, const int64_t* lives,
                    const int32_t* probes, float emin, int64_t n_g,
                    int64_t nq, int m, int h, int k, int nprobe,
                    int64_t nlist) {
  if (m <= 0 || h <= 0 || k <= 0 || nprobe <= 0 || nlist <= 0) return 1;
  for (int64_t p = 0; p <= nlist; ++p)
    if (starts[p] % 64 || starts[p] > n_g || (p && starts[p] < starts[p - 1]))
      return 1;
  for (int64_t p = 0; p < nlist; ++p)
    if (lives[p] < 0 || lives[p] > starts[p + 1] - starts[p]) return 1;
  auto fill = adc_block<0>;
  if (m == 7) fill = adc_block<7>;
  if (m == 8) fill = adc_block<8>;
  if (m == 15) fill = adc_block<15>;
  if (m == 16) fill = adc_block<16>;

  bool heap_mode = k <= 256;
  if (const char* e = std::getenv("LSQ_NATIVE_TOPK")) {
    if (std::strcmp(e, "heap") == 0) heap_mode = true;
    if (std::strcmp(e, "buf") == 0) heap_mode = false;
  }

#ifdef LSQ_HAVE_VBMI
  const bool use_vbmi = codesT_g != nullptr && m <= 32;
  const int hc = h < 256 ? h : 256;
  // Shared u8 quantization step across every query of the call (same
  // contract as lsq_linscan_fast so the pruning-bound proof carries over).
  std::vector<float> lut_min;
  double s = 0.0;
  if (use_vbmi) {
    lut_min.resize((size_t)nq * m);
    double max_span = 0.0;
    for (int64_t qj = 0; qj < nq * (int64_t)m; ++qj) {
      const float* l = luts + qj * (int64_t)h;
      float lo = l[0], hi = l[0];
      for (int v = 1; v < hc; ++v) {
        lo = std::min(lo, l[v]);
        hi = std::max(hi, l[v]);
      }
      lut_min[qj] = lo;
      max_span = std::max(max_span, (double)hi - (double)lo);
    }
    s = max_span > 0 ? 255.0 / max_span : 0.0;
  }
#else
  const bool use_vbmi = false;
#endif

#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t q = 0; q < nq; ++q) {
    const float* lut = luts + q * (int64_t)m * h;
    TopK tk;
    tk.init(k, heap_mode);
    const int32_t* pr = probes + q * (int64_t)nprobe;

#ifdef LSQ_HAVE_VBMI
    if (use_vbmi) {
      alignas(64) uint8_t tbl[32][256];
      double offq = extra_g ? (double)emin : 0.0;
      for (int j = 0; j < m; ++j) {
        const float mn = lut_min[q * m + j];
        offq += (double)mn;
        for (int v = 0; v < hc; ++v) {
          const double t = ((double)lut[(int64_t)j * h + v] - (double)mn) * s;
          tbl[j][v] = (uint8_t)(t >= 255.0 ? 255 : (t <= 0 ? 0 : (int)t));
        }
        for (int v = hc; v < 256; ++v) tbl[j][v] = 255;
      }
      const double eq_cap = 65535.0 - 255.0 * m;

      for (int pi = 0; pi < nprobe; ++pi) {
        const int32_t p = pr[pi];
        if (p < 0) continue;
        if (p >= nlist) continue;
        const int64_t s0 = starts[p];
        const int64_t live = lives[p];
        for (int64_t r = s0; r < s0 + live; r += 64) {
          const int64_t in_chunk = std::min<int64_t>(64, s0 + live - r);
          // Same screen as lsq_linscan_fast's main loop, with two IVF
          // deltas: the norm term quantizes inline per chunk (the scale s
          // is per-call, so a persistent eq[] would rebuild O(n_g) work
          // per call this entry exists to avoid), and a live-mask drops
          // the segment's alignment-pad lanes.
          const double td = ((double)tk.thresh - offq) * s;
          bool take_all = false;
          uint32_t tq = 0;
          if (!((double)tk.thresh > offq)) {
            continue;
          } else if (s == 0.0 || td >= 65532.0 - m) {
            take_all = true;
          } else {
            tq = (uint32_t)td + (uint32_t)m + 2;
          }

          __m512i sum_lo, sum_hi;
          if (extra_g) {
            alignas(64) uint16_t eq[64];
            for (int i = 0; i < 64; ++i) {
              const double v =
                  ((double)extra_g[r + (i < in_chunk ? i : 0)] -
                   (double)emin) * s;
              eq[i] = (uint16_t)(v <= 0 ? 0 : (v >= eq_cap ? eq_cap : v));
            }
            sum_lo = _mm512_load_si512((const void*)eq);
            sum_hi = _mm512_load_si512((const void*)(eq + 32));
          } else {
            sum_lo = _mm512_setzero_si512();
            sum_hi = _mm512_setzero_si512();
          }
          for (int j = 0; j < m; ++j) {
            const __m512i t0 = _mm512_load_si512((const void*)tbl[j]);
            const __m512i t1 = _mm512_load_si512((const void*)(tbl[j] + 64));
            const __m512i t2 = _mm512_load_si512((const void*)(tbl[j] + 128));
            const __m512i t3 = _mm512_load_si512((const void*)(tbl[j] + 192));
            const __m512i idx = _mm512_loadu_si512(
                (const void*)(codesT_g + (size_t)j * n_g + r));
            const __m512i rlo = _mm512_permutex2var_epi8(t0, idx, t1);
            const __m512i rhi = _mm512_permutex2var_epi8(t2, idx, t3);
            const __mmask64 top = _mm512_movepi8_mask(idx);
            const __m512i res = _mm512_mask_blend_epi8(top, rlo, rhi);
            sum_lo = _mm512_add_epi16(
                sum_lo, _mm512_cvtepu8_epi16(_mm512_castsi512_si256(res)));
            sum_hi = _mm512_add_epi16(
                sum_hi,
                _mm512_cvtepu8_epi16(_mm512_extracti64x4_epi64(res, 1)));
          }
          uint32_t mlo, mhi;
          if (take_all) {
            mlo = mhi = 0xFFFFFFFFu;
          } else {
            const __m512i tqv = _mm512_set1_epi16((short)(uint16_t)tq);
            mlo = (uint32_t)_mm512_cmplt_epu16_mask(sum_lo, tqv);
            mhi = (uint32_t)_mm512_cmplt_epu16_mask(sum_hi, tqv);
          }
          if (in_chunk < 64) {  // mask the alignment-pad lanes out
            const uint64_t lm =
                in_chunk >= 64 ? ~0ULL : ((1ULL << in_chunk) - 1);
            mlo &= (uint32_t)lm;
            mhi &= (uint32_t)(lm >> 32);
          }
          while (mlo | mhi) {
            int64_t row;
            if (mlo) {
              row = r + __builtin_ctz(mlo);
              mlo &= mlo - 1;
            } else {
              row = r + 32 + __builtin_ctz(mhi);
              mhi &= mhi - 1;
            }
            float d = 0.f;
            for (int j = 0; j < m; ++j)
              d += lut[(int64_t)j * h + codesT_g[(size_t)j * n_g + row]];
            if (extra_g) d += extra_g[row];
            if (d < tk.thresh) tk.add(d, order[row]);
          }
        }
      }
    } else
#endif
    {
      // Scalar path: the shared blocked two-phase loop per probed
      // segment, with original-id translation at accept time.
      struct MapSink {
        TopK& tk;
        const int64_t* order;
        float thresh;
        inline void add(float d, int64_t row) {
          tk.add(d, order[row]);
          thresh = tk.thresh;
        }
      } sink{tk, order, tk.thresh};
      for (int pi = 0; pi < nprobe; ++pi) {
        const int32_t p = pr[pi];
        if (p < 0 || p >= nlist) continue;
        sink.thresh = tk.thresh;
        scan_range_exact(fill, extra_g, sink, starts[p],
                         starts[p] + lives[p], codes_g, lut, m, h);
      }
    }

    tk.finish();
    float* dq = dists + q * (int64_t)k;
    int64_t* iq = ids_out + q * (int64_t)k;
    const int64_t got = (int64_t)tk.buf.size();
    for (int64_t j = 0; j < k; ++j) {
      dq[j] = j < got ? tk.buf[j].first
                      : std::numeric_limits<float>::infinity();
      iq[j] = j < got ? tk.buf[j].second : -1;
    }
  }
  return 0;
}

// Bulk TEXMEX reader. Each record: int32 dim header + dim * scalar_bytes.
//   out      : caller-allocated, count * dim * scalar_bytes bytes
//   dim_out  : receives the per-record dimension
//   returns number of records read, or -1 on format error, -2 on I/O error.
int64_t lsq_vecs_read(const char* path, int scalar_bytes, int64_t offset,
                      int64_t count, void* out, int* dim_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -2;
  int32_t dim = 0;
  if (std::fread(&dim, 4, 1, f) != 1 || dim <= 0) {
    std::fclose(f);
    return -1;
  }
  *dim_out = dim;
  const int64_t rec = 4 + (int64_t)dim * scalar_bytes;
#ifdef _WIN32
  std::fclose(f);
  return -2;
#else
  if (std::fseek(f, 0, SEEK_END) != 0) {
    std::fclose(f);
    return -2;
  }
  const int64_t total = std::ftell(f) / rec;
  int64_t want = count < 0 ? total - offset : count;
  if (want > total - offset) want = total - offset;
  if (want < 0) {
    std::fclose(f);
    return -1;
  }
  std::fseek(f, offset * rec, SEEK_SET);
  std::vector<uint8_t> buf(rec);
  uint8_t* dst = static_cast<uint8_t*>(out);
  const int64_t body = (int64_t)dim * scalar_bytes;
  for (int64_t i = 0; i < want; ++i) {
    if (std::fread(buf.data(), 1, rec, f) != (size_t)rec) {
      std::fclose(f);
      return -1;
    }
    int32_t d2;
    std::memcpy(&d2, buf.data(), 4);
    if (d2 != dim) {
      std::fclose(f);
      return -1;  // inconsistent record dimension
    }
    std::memcpy(dst + i * body, buf.data() + 4, body);
  }
  std::fclose(f);
  return want;
#endif
}

int lsq_native_version() { return 1; }

}  // extern "C"
