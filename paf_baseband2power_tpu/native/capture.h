/* pafb2p native UDP capture engine.
 *
 * Ground-up C++ re-design of the reference's pthread capture stack
 * (behavioral contract from capture.c / sync.c / hdr.c; SURVEY.md L0-L1):
 *
 *   - N UDP sockets (default ports 17100-17105) receive 7232-byte BMF
 *     frames: 64-byte big-endian header + 7168-byte int16 I/Q payload.
 *   - A connection probe discovers active ports and their frequency-chunk
 *     sets (NDF_CHECK frames/port, capture.c:57-144). Chunk index derives
 *     from the header FREQ field against a configured base — unlike the
 *     reference's source-IP scheme (capture.c:570-584), which cannot work
 *     on loopback or modern fabrics; FREQ carries the same information.
 *   - Frames are aligned to a common reference frame (capture.c:333-403),
 *     then per-port threads place payloads into the current ring block at
 *     (idf * nchk + ifreq) * 7168 — the TFTFP block layout.
 *   - Late/early policy (capture.c:464-534): frames before the block are
 *     dropped; frames within TBUF_NDF after it land in a temp buffer and
 *     are replayed after rotation; farther ahead forces a block switch
 *     (graceful data loss); a port an entire block behind quits.
 *   - A sync thread rotates ring blocks when every active port has moved
 *     past the current block or on force-switch (sync.c:76-219).
 *
 * Concurrency model (replacing the reference's racy int globals + 4 mutex
 * families): hot-path counters are std::atomic; block rotation uses a
 * shared_mutex (port threads take it shared around the 7 KB memcpy, the
 * sync thread exclusively during rotation).
 */

#ifndef PAFB2P_CAPTURE_H
#define PAFB2P_CAPTURE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct pafb2p_capture pafb2p_capture;

typedef struct pafb2p_capture_conf {
  char ip[64];           /* bind address, e.g. "10.17.4.1" or "127.0.0.1" */
  int port_base;         /* first UDP port (17100) */
  int nports;            /* number of ports (6) */
  char ring_key[64];     /* target ring buffer (must exist) */
  uint64_t ndf_blk;      /* frames per ring block per chunk (8192) */
  uint32_t nchk;         /* frequency chunks (48) */
  double freq_base;      /* FREQ of chunk 0 (MHz) */
  double chunk_bw;       /* FREQ spacing between chunks (MHz, 7.0) */
  uint32_t tbuf_ndf;     /* temp-buffer depth in frames (256) */
  double timeout_sec;    /* socket receive timeout (27) */
  uint64_t ndf_check;    /* probe frames per port (800) */
  double length_sec;     /* stop after this much stream time; 0 = unbounded */
  int cpu_base;          /* pin thread i to cpu_base+i; -1 = no pinning */
  int zero_blocks;       /* memset blocks on open (reference doesn't) */
  int beam;              /* accept only this beam id; -1 = any (one beam
                            per stream, like the reference's per-beam
                            deployment; hdr.c:25 carries the id) */
  int numa_node;         /* NUMA-aware pinning: thread i lands on cpu
                            numa_node*10 + cpu_base + i, the reference's
                            `i + node*10` placement (sync.c:48-59);
                            -1 = flat cpu_base offset only */
  int device_layout;     /* 1: corner-turn frames during placement into
                            the series-row layout (one contiguous
                            512 B segment per (chunk, chan, pol) series
                            per frame) so the device computes fine-channel
                            spectra with zero relayout; 0: reference wire
                            TFTFP order */
} pafb2p_capture_conf;

pafb2p_capture *pafb2p_capture_create(const pafb2p_capture_conf *conf);
void pafb2p_capture_destroy(pafb2p_capture *h);

/* Bind sockets and probe active ports/chunks. Returns number of active
 * ports (>0) or a negative errno. */
int pafb2p_capture_probe(pafb2p_capture *h);

/* Align to a common reference frame and start capture threads. Requires a
 * successful probe. Returns 0 or negative errno. */
int pafb2p_capture_start(pafb2p_capture *h);

/* Block until capture finishes (timeout, length reached, or stop). */
int pafb2p_capture_wait(pafb2p_capture *h);
/* Request asynchronous stop. */
void pafb2p_capture_stop(pafb2p_capture *h);

/* Stream start info, valid after pafb2p_capture_start. */
uint64_t pafb2p_capture_ref_sec(const pafb2p_capture *h);
uint64_t pafb2p_capture_ref_idf(const pafb2p_capture *h);
uint32_t pafb2p_capture_epoch(const pafb2p_capture *h);
double pafb2p_capture_freq_center(const pafb2p_capture *h);
int pafb2p_capture_active_ports(const pafb2p_capture *h);
int pafb2p_capture_active_chunks(const pafb2p_capture *h);

/* Statistics (valid any time after start; final after wait). */
uint64_t pafb2p_capture_frames_received(const pafb2p_capture *h, int port);
uint64_t pafb2p_capture_frames_expected(const pafb2p_capture *h, int port);
uint64_t pafb2p_capture_frames_dropped(const pafb2p_capture *h, int port);
/* frames rejected for a cleared header valid bit (hdr.c:15-16) */
uint64_t pafb2p_capture_frames_invalid(const pafb2p_capture *h, int port);
/* wall-clock seconds between the port's first and last accepted frame
 * (per-socket elapsed_time, capture.c:450,552) */
double pafb2p_capture_port_elapsed(const pafb2p_capture *h, int port);
uint64_t pafb2p_capture_blocks_committed(const pafb2p_capture *h);
uint64_t pafb2p_capture_force_switches(const pafb2p_capture *h);

#ifdef __cplusplus
}
#endif

#endif /* PAFB2P_CAPTURE_H */
