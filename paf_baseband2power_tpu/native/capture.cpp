/* Implementation of the pafb2p UDP capture engine (see capture.h). */

#include "capture.h"
#include "ringbuf.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <pthread.h>
#include <sched.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#if defined(__x86_64__)
#include <immintrin.h>
#endif
#include <cmath>
#include <cstring>
#include <mutex>
#include <set>
#include <shared_mutex>
#include <thread>
#include <vector>

namespace {

constexpr size_t kFrameBytes = 7232;
constexpr size_t kHdrBytes = 64;
constexpr size_t kPayloadBytes = 7168;
constexpr uint64_t kNdfPrd = 250000; /* frames per 27 s period per chunk */
constexpr uint64_t kPrdSec = 27;
constexpr int kMaxPorts = 16;

struct FrameHdr {
  uint64_t idf;
  uint64_t sec;
  uint32_t epoch;
  uint32_t beam;
  double freq;
  bool valid;
};

/* Big-endian 64-bit header words (layout contract: hdr.c:10-28). */
FrameHdr decode_hdr(const uint8_t *buf) {
  uint64_t w0, w1, w2;
  memcpy(&w0, buf, 8);
  memcpy(&w1, buf + 8, 8);
  memcpy(&w2, buf + 16, 8);
  w0 = __builtin_bswap64(w0);
  w1 = __builtin_bswap64(w1);
  w2 = __builtin_bswap64(w2);
  FrameHdr h;
  h.idf = w0 & 0xffffffffULL;
  h.sec = (w0 >> 32) & 0x3fffffffULL;
  h.valid = (w0 >> 63) & 1;
  h.epoch = (w1 >> 26) & 0x3f;
  h.freq = static_cast<double>((w2 >> 16) & 0xffff);
  h.beam = w2 & 0xffff;
  return h;
}

/* Global frame index: sec advances in whole 27 s periods at period starts,
 * so dsec * NDF_PRD / 27 is exact (acquire_idf contract, capture.c:562-568). */
uint64_t global_idf(const FrameHdr &h) {
  return (h.sec / kPrdSec) * kNdfPrd + h.idf;
}

double monotonic_sec() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<double>(ts.tv_sec) + 1e-9 * ts.tv_nsec;
}

struct PortStats {
  std::atomic<uint64_t> received{0};
  std::atomic<uint64_t> dropped{0};
  std::atomic<uint64_t> invalid{0};
  std::atomic<uint64_t> last_g{0};
  std::atomic<uint64_t> nchunks{0};
  std::atomic<double> t_first{0.0}; /* first accepted frame (monotonic s) */
  std::atomic<double> t_last{0.0};  /* last accepted frame */
};

} // namespace

struct pafb2p_capture {
  pafb2p_capture_conf conf;

  std::vector<int> socks;          /* bound sockets, index = port offset */
  std::vector<int> active;         /* indices of active ports */
  std::vector<std::set<int>> port_chunks; /* per-port chunk sets (probe) */
  int active_chunks = 0;

  pafb2p_rb *ring = nullptr;
  uint8_t *cur_block = nullptr;

  /* reference frame (stream start) */
  uint64_t ref_g = 0;
  uint64_t ref_sec = 0, ref_idf = 0;
  uint32_t epoch = 0;
  double freq_min = 0, freq_max = 0;
  uint64_t end_g = ~0ULL;

  /* rotation state */
  std::shared_mutex rot_mu;        /* shared: frame memcpy; exclusive: rotate */
  std::atomic<uint64_t> block_base{0};
  std::atomic<bool> force_switch{false};
  std::atomic<bool> quit{false};
  std::atomic<bool> stop_req{false};
  std::vector<std::atomic<bool> *> in_next;   /* per active port */
  std::vector<std::atomic<bool> *> finished;  /* per active port */

  /* temp buffer for early frames (capture.c:525-534 analogue) */
  std::vector<uint8_t> tbuf;
  std::vector<uint8_t> ttag;

  /* per-slot fill tags for the current block (zero_blocks support).
   * Written by capture threads under the shared lock (each slot belongs to
   * exactly one port — the sender's chunk->port mapping — so no two threads
   * touch the same byte); scanned/cleared by rotation under the exclusive
   * lock. This replaces the old whole-block memset in rotate_block, which
   * held rot_mu exclusively for hundreds of ms at full geometry (2.8 GB)
   * while every capture thread blocked — burning the entire tbuf headroom
   * at the real 444k frames/s. Now rotation zeroes only the slots that
   * never arrived (nothing, at zero loss) and the fresh block needs no
   * zeroing at all. (The reference never zeroes, sync.c:101-110; zeroing is
   * this engine's stronger guarantee that lost frames read as silence.) */
  std::vector<uint8_t> filled;

  PortStats stats[kMaxPorts];
  std::atomic<uint64_t> blocks_committed{0};
  std::atomic<uint64_t> nforce{0};

  std::vector<std::thread> threads;
  bool started = false;

  ~pafb2p_capture() {
    for (int s : socks)
      if (s >= 0)
        close(s);
    if (ring) {
      pafb2p_rb_disconnect(ring);
    }
  }
};

namespace {

void pin_thread(int cpu) {
  if (cpu < 0)
    return;
  cpu_set_t set;
  CPU_ZERO(&set);
  CPU_SET(cpu, &set);
  pthread_setaffinity_np(pthread_self(), sizeof(set), &set);
}

/* NUMA-aware placement: thread `slot` of a capture on NUMA node n lands on
 * cpu n*10 + base + slot — the reference's `i + node*10` affinity
 * (sync.c:48-59). With numa_node < 0 this is a flat cpu_base offset; with
 * both unset, no pinning. */
int thread_cpu(const pafb2p_capture_conf &conf, int slot) {
  if (conf.cpu_base < 0 && conf.numa_node < 0)
    return -1;
  int base = conf.cpu_base < 0 ? 0 : conf.cpu_base;
  if (conf.numa_node >= 0)
    base += conf.numa_node * 10;
  return base + slot;
}

int chunk_of(const pafb2p_capture *h, double freq) {
  double f = (freq - h->conf.freq_base) / h->conf.chunk_bw;
  int i = static_cast<int>(lround(f));
  if (i < 0 || i >= static_cast<int>(h->conf.nchk))
    return -1;
  return i;
}

/* Zero the slots of the current block that no frame ever filled, so lost
 * frames read as silence. Caller holds rot_mu exclusively (no concurrent
 * fill-tag writes). At zero loss this is one all-ones word scan over the
 * tag array (~50 us at full geometry) — the affordable form of the old
 * 2.8 GB whole-block memset. */
/* ---- device-layout corner turn -----------------------------------------
 *
 * The fine-channel steps consume per-series rows: the corner turn from
 * the wire's sample-major payload is a full-block transpose on the
 * device, while the host can do it during frame placement nearly for
 * free. A frame payload
 * is a 128x14 matrix of 4-byte (re,im) int16 pairs (sample-major); the
 * device layout stores column cls of frame (idf, ichk) as the contiguous
 * 512 B segment at ((ichk*14 + cls)*ndf_blk + idf)*512 — exactly the
 * (nseries, ndf, 256-lane) row form, so the device computes spectra with
 * zero relayout. Block size is unchanged.
 */
constexpr uint32_t kClsPerChunk = 14; /* 7 chan x 2 pol (4 B re/im pair) */
constexpr uint32_t kSegBytes = 512;   /* 128 samples x 4 B per series    */

void corner_turn_scalar(const uint8_t *payload, uint8_t *block,
                        uint64_t idf, uint32_t ichk, uint64_t ndf_blk) {
  const uint32_t *src = reinterpret_cast<const uint32_t *>(payload);
  for (uint32_t cls = 0; cls < kClsPerChunk; ++cls) {
    uint32_t *dst = reinterpret_cast<uint32_t *>(
        block + ((static_cast<uint64_t>(ichk) * kClsPerChunk + cls) *
                     ndf_blk +
                 idf) *
                    kSegBytes);
    for (uint32_t s = 0; s < 128; ++s)
      dst[s] = src[s * kClsPerChunk + cls];
  }
}

#if defined(__x86_64__)
/* 8x8 u32 transpose of rows r..r+7, cols c..c+7 (src stride 14 u32) into
 * 8 column segments (dst stride 128 u32 between columns). */
__attribute__((target("avx2"))) static inline void t8x8(
    const uint32_t *src, uint32_t *dst0, uint64_t dst_stride) {
  __m256i r0 = _mm256_loadu_si256((const __m256i *)(src + 0 * 14));
  __m256i r1 = _mm256_loadu_si256((const __m256i *)(src + 1 * 14));
  __m256i r2 = _mm256_loadu_si256((const __m256i *)(src + 2 * 14));
  __m256i r3 = _mm256_loadu_si256((const __m256i *)(src + 3 * 14));
  __m256i r4 = _mm256_loadu_si256((const __m256i *)(src + 4 * 14));
  __m256i r5 = _mm256_loadu_si256((const __m256i *)(src + 5 * 14));
  __m256i r6 = _mm256_loadu_si256((const __m256i *)(src + 6 * 14));
  __m256i r7 = _mm256_loadu_si256((const __m256i *)(src + 7 * 14));
  __m256i t0 = _mm256_unpacklo_epi32(r0, r1);
  __m256i t1 = _mm256_unpackhi_epi32(r0, r1);
  __m256i t2 = _mm256_unpacklo_epi32(r2, r3);
  __m256i t3 = _mm256_unpackhi_epi32(r2, r3);
  __m256i t4 = _mm256_unpacklo_epi32(r4, r5);
  __m256i t5 = _mm256_unpackhi_epi32(r4, r5);
  __m256i t6 = _mm256_unpacklo_epi32(r6, r7);
  __m256i t7 = _mm256_unpackhi_epi32(r6, r7);
  __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
  __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
  __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
  __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
  __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
  __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
  __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
  __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
  _mm256_storeu_si256((__m256i *)(dst0 + 0 * dst_stride),
                      _mm256_permute2x128_si256(u0, u4, 0x20));
  _mm256_storeu_si256((__m256i *)(dst0 + 1 * dst_stride),
                      _mm256_permute2x128_si256(u1, u5, 0x20));
  _mm256_storeu_si256((__m256i *)(dst0 + 2 * dst_stride),
                      _mm256_permute2x128_si256(u2, u6, 0x20));
  _mm256_storeu_si256((__m256i *)(dst0 + 3 * dst_stride),
                      _mm256_permute2x128_si256(u3, u7, 0x20));
  _mm256_storeu_si256((__m256i *)(dst0 + 4 * dst_stride),
                      _mm256_permute2x128_si256(u0, u4, 0x31));
  _mm256_storeu_si256((__m256i *)(dst0 + 5 * dst_stride),
                      _mm256_permute2x128_si256(u1, u5, 0x31));
  _mm256_storeu_si256((__m256i *)(dst0 + 6 * dst_stride),
                      _mm256_permute2x128_si256(u2, u6, 0x31));
  _mm256_storeu_si256((__m256i *)(dst0 + 7 * dst_stride),
                      _mm256_permute2x128_si256(u3, u7, 0x31));
}

__attribute__((target("avx2"))) void corner_turn_avx2(
    const uint8_t *payload, uint8_t *block, uint64_t idf, uint32_t ichk,
    uint64_t ndf_blk) {
  const uint32_t *src = reinterpret_cast<const uint32_t *>(payload);
  uint32_t *base = reinterpret_cast<uint32_t *>(
      block + static_cast<uint64_t>(ichk) * kClsPerChunk * ndf_blk *
                  kSegBytes);
  const uint64_t seg_u32 = ndf_blk * 128; /* u32 stride between columns */
  for (uint32_t r = 0; r < 128; r += 8) {
    /* cols 0..7, then cols 6..13 (6,7 written twice with equal values —
     * the overlap keeps both loads fully in-bounds of the 1792-u32 row) */
    t8x8(src + r * 14, base + 0 * seg_u32 + idf * 128 + r, seg_u32);
    t8x8(src + r * 14 + 6, base + 6 * seg_u32 + idf * 128 + r, seg_u32);
  }
}
#endif

using corner_turn_fn = void (*)(const uint8_t *, uint8_t *, uint64_t,
                                uint32_t, uint64_t);

corner_turn_fn pick_corner_turn() {
#if defined(__x86_64__)
  if (__builtin_cpu_supports("avx2"))
    return corner_turn_avx2;
#endif
  return corner_turn_scalar;
}

corner_turn_fn g_corner_turn = pick_corner_turn();

/* Place one frame payload into the current block in the configured
 * layout (wire TFTFP memcpy, or the device-layout corner turn). */
inline void place_frame(pafb2p_capture *h, uint8_t *block, uint64_t idf,
                        uint32_t ifreq, const uint8_t *payload) {
  if (h->conf.device_layout)
    g_corner_turn(payload, block, idf, ifreq, h->conf.ndf_blk);
  else
    memcpy(block + (idf * h->conf.nchk + ifreq) * kPayloadBytes, payload,
           kPayloadBytes);
}

void zero_unfilled(pafb2p_capture *h) {
  if (!h->conf.zero_blocks || !h->cur_block)
    return;
  if (h->conf.device_layout) {
    /* an unfilled (idf, ichk) slot is kClsPerChunk scattered segments;
     * same all-ones word-scan fast path as the wire branch so a
     * zero-loss rotation stays ~50 us under the exclusive lock */
    const uint64_t ndf = h->conf.ndf_blk;
    const uint32_t nchk = h->conf.nchk;
    const uint64_t nslots = ndf * nchk;
    const uint8_t *f = h->filled.data();
    constexpr uint64_t kAllFilled = 0x0101010101010101ULL;
    auto zero_slot = [&](uint64_t i) {
      uint64_t idf = i / nchk;
      uint32_t ichk = static_cast<uint32_t>(i % nchk);
      for (uint32_t cls = 0; cls < kClsPerChunk; ++cls)
        memset(h->cur_block +
                   ((static_cast<uint64_t>(ichk) * kClsPerChunk + cls) *
                        ndf +
                    idf) *
                       kSegBytes,
               0, kSegBytes);
    };
    uint64_t i = 0;
    for (; i + 8 <= nslots; i += 8) {
      uint64_t w;
      memcpy(&w, f + i, 8);
      if (w == kAllFilled)
        continue;
      for (uint64_t j = i; j < i + 8; ++j)
        if (!f[j])
          zero_slot(j);
    }
    for (; i < nslots; ++i)
      if (!f[i])
        zero_slot(i);
    return;
  }
  const uint64_t nslots =
      static_cast<uint64_t>(h->conf.ndf_blk) * h->conf.nchk;
  const uint8_t *f = h->filled.data();
  constexpr uint64_t kAllFilled = 0x0101010101010101ULL;
  uint64_t i = 0;
  for (; i + 8 <= nslots; i += 8) {
    uint64_t w;
    memcpy(&w, f + i, 8);
    if (w == kAllFilled)
      continue;
    for (uint64_t j = i; j < i + 8; ++j)
      if (!f[j])
        memset(h->cur_block + j * kPayloadBytes, 0, kPayloadBytes);
  }
  for (; i < nslots; ++i)
    if (!f[i])
      memset(h->cur_block + i * kPayloadBytes, 0, kPayloadBytes);
}

/* Rotate to the next ring block. Caller holds rot_mu exclusively. */
int rotate_block(pafb2p_capture *h) {
  zero_unfilled(h);
  if (pafb2p_rb_close_block_write(h->ring, pafb2p_rb_bufsz(h->ring)) != 0)
    return -EIO;
  h->blocks_committed.fetch_add(1);
  /* the committed block now belongs to the reader: the stale pointer must
   * not survive an open failure, or the final EOD path would re-zero and
   * re-close reader-owned memory */
  h->cur_block = nullptr;
  uint8_t *nb = pafb2p_rb_open_block_write(h->ring, 3600ULL * 1000000);
  if (!nb)
    return -ETIMEDOUT;
  h->cur_block = nb;
  uint64_t ndf = h->conf.ndf_blk;
  h->block_base.fetch_add(ndf);
  if (h->conf.zero_blocks)
    memset(h->filled.data(), 0, h->filled.size());
  /* replay temp-buffer frames into the fresh block (sync.c:141-170) */
  uint32_t nchk = h->conf.nchk;
  for (uint64_t t = 0; t < h->conf.tbuf_ndf; ++t) {
    for (uint32_t c = 0; c < nchk; ++c) {
      uint64_t slot = t * nchk + c;
      if (h->ttag[slot]) {
        /* tbuf holds raw wire frames; replay in the configured layout */
        place_frame(h, nb, t, c, h->tbuf.data() + slot * kPayloadBytes);
        h->ttag[slot] = 0;
        if (h->conf.zero_blocks)
          h->filled[slot] = 1;
      }
    }
  }
  for (auto *f : h->in_next)
    f->store(false, std::memory_order_relaxed);
  h->force_switch.store(false, std::memory_order_relaxed);
  return 0;
}

void capture_thread(pafb2p_capture *h, int slot) {
  pin_thread(thread_cpu(h->conf, slot));
  int sock = h->socks[h->active[slot]];
  PortStats &st = h->stats[h->active[slot]];
  uint8_t buf[kFrameBytes];
  uint64_t ndf = h->conf.ndf_blk;
  uint64_t tbuf_ndf = h->conf.tbuf_ndf;
  uint32_t nchk = h->conf.nchk;

  while (!h->quit.load(std::memory_order_relaxed) &&
         !h->stop_req.load(std::memory_order_relaxed)) {
    ssize_t n = recv(sock, buf, sizeof(buf), 0);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK)
        break; /* stream went silent for a full period: finish (capture.c:438-456) */
      if (errno == EINTR)
        continue;
      break;
    }
    if (static_cast<size_t>(n) != kFrameBytes) {
      st.dropped.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    FrameHdr fh = decode_hdr(buf);
    if (!fh.valid) {
      /* cleared valid bit: reject at the wire (hdr.c:15-16) */
      st.invalid.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    if (h->conf.beam >= 0 &&
        fh.beam != static_cast<uint32_t>(h->conf.beam)) {
      st.dropped.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    int ifreq = chunk_of(h, fh.freq);
    if (ifreq < 0) {
      st.dropped.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    double now = monotonic_sec();
    if (st.t_first.load(std::memory_order_relaxed) == 0.0)
      st.t_first.store(now, std::memory_order_relaxed);
    st.t_last.store(now, std::memory_order_relaxed);
    uint64_t g = global_idf(fh);
    st.last_g.store(g, std::memory_order_relaxed);
    if (g >= h->end_g) {
      h->finished[slot]->store(true);
      return;
    }

    std::shared_lock<std::shared_mutex> lk(h->rot_mu);
    if (!h->cur_block)
      break; /* sync thread already closed the stream (quit/EOD) while this
              * thread was blocked in recv */
    uint64_t base = h->block_base.load(std::memory_order_relaxed);
    int64_t rel = static_cast<int64_t>(g) - static_cast<int64_t>(base);
    if (rel < 0) {
      /* frame belongs to an already-closed block: drop (capture.c:464-466) */
      st.dropped.fetch_add(1, std::memory_order_relaxed);
    } else if (rel < static_cast<int64_t>(ndf)) {
      uint64_t slot_idx = static_cast<uint64_t>(rel) * nchk + ifreq;
      place_frame(h, h->cur_block, static_cast<uint64_t>(rel), ifreq,
                  buf + kHdrBytes);
      if (h->conf.zero_blocks)
        h->filled[slot_idx] = 1;
      st.received.fetch_add(1, std::memory_order_relaxed);
    } else if (rel < static_cast<int64_t>(ndf + tbuf_ndf)) {
      uint64_t slot_idx = (static_cast<uint64_t>(rel) - ndf) * nchk + ifreq;
      memcpy(h->tbuf.data() + slot_idx * kPayloadBytes, buf + kHdrBytes,
             kPayloadBytes);
      h->ttag[slot_idx] = 1;
      h->in_next[slot]->store(true, std::memory_order_relaxed);
      st.received.fetch_add(1, std::memory_order_relaxed);
    } else if (rel < static_cast<int64_t>(2 * ndf)) {
      /* too far ahead for the temp buffer: force a switch, frame lost
       * (graceful data loss, capture.c:510-524) */
      h->in_next[slot]->store(true, std::memory_order_relaxed);
      h->force_switch.store(true, std::memory_order_relaxed);
      st.dropped.fetch_add(1, std::memory_order_relaxed);
    } else {
      /* a full extra block behind: unrecoverable (capture.c:491-509) */
      h->quit.store(true, std::memory_order_relaxed);
      st.dropped.fetch_add(1, std::memory_order_relaxed);
      break;
    }
  }
  h->finished[slot]->store(true);
}

void sync_thread(pafb2p_capture *h) {
  pin_thread(thread_cpu(h->conf, static_cast<int>(h->active.size())));
  size_t nports = h->active.size();
  for (;;) {
    bool all_fin = true, all_next = true, any_next = false;
    for (size_t i = 0; i < nports; ++i) {
      bool fin = h->finished[i]->load(std::memory_order_relaxed);
      bool nxt = h->in_next[i]->load(std::memory_order_relaxed);
      all_fin &= fin;
      all_next &= (fin || nxt);
      any_next |= nxt;
    }
    bool force = h->force_switch.load(std::memory_order_relaxed);
    if (h->quit.load(std::memory_order_relaxed) ||
        h->stop_req.load(std::memory_order_relaxed) || all_fin)
      break;
    if ((all_next && any_next) || force) {
      std::unique_lock<std::shared_mutex> lk(h->rot_mu);
      if (force)
        h->nforce.fetch_add(1);
      if (rotate_block(h) != 0) {
        h->quit.store(true);
        break;
      }
    } else {
      usleep(200);
    }
  }
  /* final block + EOD on every exit path (sync.c:177-204); a failed
   * rotation may have already committed its block (cur_block null) — then
   * only EOD remains, no second close */
  std::unique_lock<std::shared_mutex> lk(h->rot_mu);
  if (h->cur_block) {
    zero_unfilled(h);
    pafb2p_rb_close_block_write(h->ring, pafb2p_rb_bufsz(h->ring));
    h->blocks_committed.fetch_add(1);
    h->cur_block = nullptr;
  }
  pafb2p_rb_set_eod(h->ring);
}

} // namespace

extern "C" {

pafb2p_capture *pafb2p_capture_create(const pafb2p_capture_conf *conf) {
  if (!conf || conf->nports <= 0 || conf->nports > kMaxPorts ||
      conf->ndf_blk == 0 || conf->nchk == 0 ||
      conf->tbuf_ndf > conf->ndf_blk)
    return nullptr;
  auto *h = new pafb2p_capture();
  h->conf = *conf;
  if (h->conf.chunk_bw == 0)
    h->conf.chunk_bw = 7.0;
  h->socks.assign(conf->nports, -1);
  h->port_chunks.assign(conf->nports, {});
  return h;
}

void pafb2p_capture_destroy(pafb2p_capture *h) { delete h; }

int pafb2p_capture_probe(pafb2p_capture *h) {
  /* bind sockets (init_sockets contract: capture.c:146-176) */
  for (int i = 0; i < h->conf.nports; ++i) {
    int s = socket(AF_INET, SOCK_DGRAM, 0);
    if (s < 0)
      return -errno;
    struct timeval tv;
    tv.tv_sec = static_cast<long>(h->conf.timeout_sec);
    tv.tv_usec = static_cast<long>(
        (h->conf.timeout_sec - static_cast<double>(tv.tv_sec)) * 1e6);
    setsockopt(s, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    int rcvbuf = 64 * 1024 * 1024;
    setsockopt(s, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
    struct sockaddr_in sa;
    memset(&sa, 0, sizeof(sa));
    sa.sin_family = AF_INET;
    sa.sin_port = htons(static_cast<uint16_t>(h->conf.port_base + i));
    sa.sin_addr.s_addr = inet_addr(h->conf.ip);
    if (bind(s, reinterpret_cast<struct sockaddr *>(&sa), sizeof(sa)) != 0) {
      int e = errno;
      close(s);
      return -e;
    }
    h->socks[i] = s;
  }

  /* probe: discover active ports + chunk sets (check_connection,
   * capture.c:57-144) */
  h->active.clear();
  double fmin = 1e18, fmax = -1e18;
  uint64_t max_g = 0;
  uint32_t epoch = 0;
  uint8_t buf[kFrameBytes];
  for (int i = 0; i < h->conf.nports; ++i) {
    uint64_t seen = 0;
    std::set<int> chunks;
    while (seen < h->conf.ndf_check) {
      ssize_t n = recv(h->socks[i], buf, sizeof(buf), 0);
      if (n < 0)
        break;
      if (static_cast<size_t>(n) != kFrameBytes)
        continue;
      FrameHdr fh = decode_hdr(buf);
      if (!fh.valid)
        continue;
      if (h->conf.beam >= 0 &&
          fh.beam != static_cast<uint32_t>(h->conf.beam))
        continue;
      int c = chunk_of(h, fh.freq);
      if (c < 0)
        continue;
      chunks.insert(c);
      if (fh.freq < fmin)
        fmin = fh.freq;
      if (fh.freq > fmax)
        fmax = fh.freq;
      uint64_t g = global_idf(fh);
      if (g > max_g)
        max_g = g;
      epoch = fh.epoch;
      ++seen;
      /* stop early once the chunk set is stable for a while */
      if (seen >= 64 && chunks.size() > 0 &&
          seen >= 16 * chunks.size())
        break;
    }
    if (seen > 0) {
      h->active.push_back(i);
      h->port_chunks[i] = chunks;
      h->stats[i].nchunks.store(chunks.size());
    }
  }
  if (h->active.empty())
    return -ENOTCONN;
  int total_chunks = 0;
  for (int p : h->active)
    total_chunks += static_cast<int>(h->port_chunks[p].size());
  h->active_chunks = total_chunks;
  h->epoch = epoch;
  h->freq_min = fmin;
  h->freq_max = fmax;
  /* align past the newest probed frame (align_df, capture.c:333-403) */
  h->ref_g = max_g + 1;
  h->ref_sec = (h->ref_g / kNdfPrd) * kPrdSec;
  h->ref_idf = h->ref_g % kNdfPrd;
  return static_cast<int>(h->active.size());
}

int pafb2p_capture_start(pafb2p_capture *h) {
  if (h->active.empty() || h->started)
    return -EINVAL;
  h->ring = pafb2p_rb_connect(h->conf.ring_key);
  if (!h->ring)
    return -ENOENT;
  uint64_t want = h->conf.ndf_blk * h->conf.nchk * kPayloadBytes;
  if (pafb2p_rb_bufsz(h->ring) != want)
    return -EINVAL; /* size check at attach (capture.c:600-612) */
  if (pafb2p_rb_lock_write(h->ring) != 0)
    return -EBUSY;
  h->cur_block = pafb2p_rb_open_block_write(h->ring, 60ULL * 1000000);
  if (!h->cur_block)
    return -ETIMEDOUT;
  if (h->conf.zero_blocks)
    /* fill tags (not a block memset): unfilled slots are zeroed at close */
    h->filled.assign(static_cast<size_t>(h->conf.ndf_blk) * h->conf.nchk, 0);

  h->block_base.store(h->ref_g);
  if (h->conf.length_sec > 0) {
    double frames = h->conf.length_sec / 1.08e-4;
    h->end_g = h->ref_g + static_cast<uint64_t>(frames);
  }
  h->tbuf.assign(static_cast<size_t>(h->conf.tbuf_ndf) * h->conf.nchk *
                     kPayloadBytes,
                 0);
  h->ttag.assign(static_cast<size_t>(h->conf.tbuf_ndf) * h->conf.nchk, 0);
  for (size_t i = 0; i < h->active.size(); ++i) {
    h->in_next.push_back(new std::atomic<bool>(false));
    h->finished.push_back(new std::atomic<bool>(false));
  }
  for (size_t i = 0; i < h->active.size(); ++i)
    h->threads.emplace_back(capture_thread, h, static_cast<int>(i));
  h->threads.emplace_back(sync_thread, h);
  h->started = true;
  return 0;
}

int pafb2p_capture_wait(pafb2p_capture *h) {
  if (!h->started)
    return -EINVAL;
  for (auto &t : h->threads)
    if (t.joinable())
      t.join();
  h->threads.clear();
  pafb2p_rb_unlock_write(h->ring);
  for (auto *p : h->in_next)
    delete p;
  for (auto *p : h->finished)
    delete p;
  h->in_next.clear();
  h->finished.clear();
  h->started = false;
  return h->quit.load() ? 1 : 0;
}

void pafb2p_capture_stop(pafb2p_capture *h) { h->stop_req.store(true); }

uint64_t pafb2p_capture_ref_sec(const pafb2p_capture *h) { return h->ref_sec; }
uint64_t pafb2p_capture_ref_idf(const pafb2p_capture *h) { return h->ref_idf; }
uint32_t pafb2p_capture_epoch(const pafb2p_capture *h) { return h->epoch; }
double pafb2p_capture_freq_center(const pafb2p_capture *h) {
  return (h->freq_min + h->freq_max) / 2.0;
}
int pafb2p_capture_active_ports(const pafb2p_capture *h) {
  return static_cast<int>(h->active.size());
}
int pafb2p_capture_active_chunks(const pafb2p_capture *h) {
  return h->active_chunks;
}

uint64_t pafb2p_capture_frames_received(const pafb2p_capture *h, int port) {
  return port < kMaxPorts ? h->stats[port].received.load() : 0;
}
uint64_t pafb2p_capture_frames_dropped(const pafb2p_capture *h, int port) {
  return port < kMaxPorts ? h->stats[port].dropped.load() : 0;
}
uint64_t pafb2p_capture_frames_invalid(const pafb2p_capture *h, int port) {
  return port < kMaxPorts ? h->stats[port].invalid.load() : 0;
}
double pafb2p_capture_port_elapsed(const pafb2p_capture *h, int port) {
  if (port >= kMaxPorts)
    return 0.0;
  const PortStats &st = h->stats[port];
  double t0 = st.t_first.load(), t1 = st.t_last.load();
  return (t0 > 0.0 && t1 > t0) ? t1 - t0 : 0.0;
}
uint64_t pafb2p_capture_frames_expected(const pafb2p_capture *h, int port) {
  if (port >= kMaxPorts)
    return 0;
  const PortStats &st = h->stats[port];
  uint64_t last = st.last_g.load();
  if (last < h->ref_g)
    return 0;
  return (last - h->ref_g + 1) * st.nchunks.load();
}
uint64_t pafb2p_capture_blocks_committed(const pafb2p_capture *h) {
  return h->blocks_committed.load();
}
uint64_t pafb2p_capture_force_switches(const pafb2p_capture *h) {
  return h->nforce.load();
}

} /* extern "C" */
