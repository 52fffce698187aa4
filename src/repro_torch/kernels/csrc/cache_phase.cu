// Phase 1 of a simulated cycle (the cache phases) for every node of the
// mesh at once, written for Hopper (sm_90a): the LSPD cache, directory and
// migration FSM of the paper's S1..S14, phase 1a's inbound completion
// handler and then phase 1b's trace-driven FSM.
//
// Replaces: repro_torch/core/cache.py's phase1a and phase1b on the cycle
// that the driver captures as a CUDA graph (core/sim.py, _cycle with
// in_place), where they are ~1,370 small ATen kernels a cycle (760 in 1a,
// 606 in 1b, each one op over all nodes: gathers, casts, selects, the
// clones of commit_queue's send queue).  Their plain version is those
// torch phases themselves, which every other path runs (the pure cycle,
// the CPU, the sharded driver): phase1_cache_kernel agrees with
// phase1b(phase1a(...)) bit for bit, leaf for leaf, sink slots included.
//
// What bounds it: bytes, in 32-byte sectors, because a node's words are
// scattered.  A node reads and writes its FSM words (ten int32 leaves,
// coalesced across nodes: about 80 B), its pending queue (20 B a slot,
// 80 B at depth 4, read and written whole when the head is served: up to
// 6 sectors), up to two trace words (a sector each), and writes six
// send-queue rows of 24 B (three a phase; the rows that are not accepted
// go to the sink slot, so every node writes at least two rows, 2-4
// sectors).  Where a handler fires it also touches its forwarding table
// (32 B at 4 entries), a directory word, and the L1 and L2 sets it probes
// or installs into: each way array of a set is one sector (3 L1 arrays,
// up to 4 sets; 5 L2 arrays, up to 3 sets).  An idle node costs about
// 0.4 KB, a busy one 1.2-1.5 KB: 20-65 MB a cycle at 208x208 (43,264
// nodes), 6-20 us at the H100's 3.35 TB/s.  The integer work, a few
// hundred operations a node, is never the limit.
//
// Design: one thread per node, the paper's own layout (one GPU thread per
// router), in CTAs of 128 nodes.  Each thread runs its node's phase 1a
// handler and then its phase 1b FSM, statement for statement in the order
// the torch phases apply them, reading every L1/L2 entry in its storage
// dtype (1, 2 or 4 bytes, read from the arguments) and writing it back
// narrowed as state.narrow_state does (l2_streak saturating at int16's
// maximum).
// Nothing is shared between nodes: a handler reads and writes only its own
// node's rows, and a directory entry only at its home (the flat layout's
// entries are each touched by one node a cycle: same entry, same home,
// same node; a centralized directory homes every tag at node 0).  The
// masked-off rows the torch phases route to sink slots are reproduced
// where they are read (the directory's sink, never written) and written
// (the send queue's sink slot, whose last row a node writes stays).  The
// working int32 leaves are written in place, so the caller's state holds
// the phase's result.  The only shared words are the statistics: each
// thread counts its increments, the CTA sums them (a warp reduction, then
// shared memory) and adds them to the statistics vector with one atomic
// a statistic; integer sums give the same total in any order.
//
// The C entry point takes a pointer to the argument struct and the stream
// and returns cudaGetLastError(), so the Python wrapper
// (kernels/cache_phase.py) binds it with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

// The kernel's arguments, as the wrapper's ctypes structure lays them out
// (outside the anonymous namespace: the exported entry point takes a
// pointer to it).  Every pointer first, then every int.
struct Phase1Args {
  int32_t* st;              // (n,) the cycle's int32 working leaves,
  int32_t* ctr;             //      read and written in place
  int32_t* tr_ptr;
  int32_t* pend_addr;
  int32_t* install_mode;
  int32_t* pkt_ctr;
  int32_t* lru_clock;
  int32_t* dir_loc;         // flat (dir_cols,) or home (n, dir_cols)
  int32_t* fwd_tag;         // (n, fwd_entries)
  int32_t* fwd_dst;
  int32_t* fwd_ptr;         // (n,)
  int32_t* q_desc;          // (n, send_queue + 1, NUM_Q)
  int32_t* q_size;          // (n,)
  int32_t* pc;              // (n, pc_depth, NUM_P)
  int32_t* stats;           // (NUM_STATS,) the low words
  const int32_t* q_head;    // (n,)
  const int32_t* knob_mig;      // () on the device: never read on the host
  const int32_t* knob_mig_thr;
  const int32_t* knob_central;
  void* l1_tag;             // (n, l1_sets, l1_ways), storage dtypes
  void* l1_lru;
  void* l1_owner;
  void* l2_tag;             // (n, l2_sets, l2_ways), storage dtypes
  void* l2_lru;
  void* l2_mig;
  void* l2_last;
  void* l2_streak;
  const void* trace;        // (n, trace_len), storage dtype
  int n, l1_sets, l1_ways, l2_sets, l2_ways, l1_shift, l2_shift, pc_depth,
      fwd_entries, send_queue, pkt_wrap, dir_home, dir_cols, trace_len,
      l1_miss_cycles, l2_hit_cycles, mem_cycles, req_timeout, es_l1_tag,
      es_l1_lru, es_l1_owner, es_l2_tag, es_l2_lru, es_l2_mig, es_l2_last,
      es_l2_streak, es_trace;
};

namespace {

constexpr int TILE = 128;  // nodes (and threads) a CTA

// message types, FSM states and install targets (core/config.py)
constexpr int MSG_REQ = 0, MSG_RA = 1, MSG_NACK = 2, MSG_DA = 3, MSG_DR = 4,
              MSG_DU = 5, MSG_WB = 6, MSG_B2 = 7, MSG_MIG_ACK = 8,
              MSG_REQ_FWD = 9;
constexpr int ST_IDLE = 0, ST_L1_WAIT = 1, ST_L2_WAIT = 2, ST_WAIT_DIR = 3,
              ST_WAIT_DATA = 4, ST_WAIT_MEM = 5, ST_DONE = 6;
constexpr int INSTALL_L2 = 0, INSTALL_L1_ONLY = 1;
// packet length by message type (FLITS_OF) and S14's worst-case need
// (cache.py's NEED_OF), indexed by the type clamped to 0..9
__constant__ int FLITS_OF[10] = {1, 4, 1, 1, 1, 1, 4, 16, 1, 1};
__constant__ int NEED_OF[10] = {2, 1, 0, 1, 1, 0, 0, 3, 0, 2};

// record fields (core/state.py)
constexpr int NUM_Q = 6;
constexpr int P_VALID = 0, P_TYP = 1, P_SRC = 2, P_OSRC = 3, P_TAG = 4;
constexpr int NUM_P = 5;

// statistics, in STAT_NAMES order (core/state.py)
constexpr int STAT_REQ_MADE = 0, STAT_REQ_RCVD = 1, STAT_REPLY_SENT = 2,
              STAT_REPLY_RCVD = 3, STAT_TRAP = 4, STAT_REDIRECTION = 5,
              STAT_DIR_SEARCH = 6, STAT_DIR_UPDATE = 7, STAT_MEM_REQ = 8,
              STAT_MIGRATIONS = 9, STAT_MIGRATIONS_DONE = 10,
              STAT_L1_HITS = 11, STAT_L1_MISSES = 12,
              STAT_L2_LOCAL_HITS = 13, STAT_L2_LOCAL_MISSES = 14,
              STAT_WB_SENT = 15, STAT_WB_RCVD = 16, STAT_WB_MISS = 17,
              STAT_SEND_DROP = 22, STAT_L2_INSTALL_DROP = 23,
              STAT_STRAY = 24;
constexpr int NUM_STATS = 25;

constexpr unsigned int BIG = 1u << 30;  // the L2 victim key's migration bias
constexpr int STREAK_MAX = 32767;       // l2_streak saturates in int16

// an entry of an array stored in es bytes, widened
__device__ __forceinline__ int ld(const void* p, int es, int64_t k) {
  if (es == 1) return static_cast<const int8_t*>(p)[k];
  if (es == 2) return static_cast<const int16_t*>(p)[k];
  return static_cast<const int32_t*>(p)[k];
}

// write v narrowed to es bytes (a cast wraps, as torch's does)
__device__ __forceinline__ void put(void* p, int es, int64_t k, int v) {
  if (es == 1) static_cast<int8_t*>(p)[k] = static_cast<int8_t>(v);
  else if (es == 2) static_cast<int16_t*>(p)[k] = static_cast<int16_t>(v);
  else static_cast<int32_t*>(p)[k] = v;
}

// A packet descriptor slot: one potential enqueue of the node.
struct Desc {
  bool v;
  int typ, dst, osrc, tag;
};

// cache.merge_desc: b's fields where b is valid
__device__ __forceinline__ void merge(Desc& a, bool v, int typ, int dst,
                                      int osrc, int tag) {
  if (v) a = Desc{true, typ, dst, osrc, tag};
}
__device__ __forceinline__ void merge(Desc& a, const Desc& b) {
  if (b.v) a = b;
}

// A node's view of the arguments: its id and the offsets of its rows.
struct Node {
  const Phase1Args& a;
  int i;               // node id (the unsharded mesh: row == id)
  unsigned int* cnt;   // its statistic increments

  __device__ __forceinline__ int64_t l1(int s, int w) const {
    return (static_cast<int64_t>(i) * a.l1_sets + s) * a.l1_ways + w;
  }
  __device__ __forceinline__ int64_t l2(int s, int w) const {
    return (static_cast<int64_t>(i) * a.l2_sets + s) * a.l2_ways + w;
  }
  __device__ __forceinline__ int l1_tag(int s, int w) const {
    return ld(a.l1_tag, a.es_l1_tag, l1(s, w));
  }
  __device__ __forceinline__ int l2_tag(int s, int w) const {
    return ld(a.l2_tag, a.es_l2_tag, l2(s, w));
  }
  __device__ __forceinline__ void bump(int k, bool x) const { cnt[k] += x; }

  // directory home of a tag (cache.dir_home_v)
  __device__ __forceinline__ int home(int tag, int central) const {
    return central > 0 ? 0 : (tag >= 0 ? tag % a.n : 0);
  }
  // cache.dir_read / dir_write: masked-off rows read the sink slot, and
  // write nothing (the torch scatter writes the sink's value back)
  __device__ __forceinline__ int64_t dir_at(int tag, bool eff) const {
    if (!a.dir_home) return eff ? tag : a.dir_cols - 1;
    return static_cast<int64_t>(i) * a.dir_cols +
           (eff ? tag / a.n : a.dir_cols - 1);
  }
  __device__ __forceinline__ int dir_read(int tag, bool mask) const {
    return a.dir_loc[dir_at(tag, mask && tag >= 0)];
  }
  __device__ __forceinline__ void dir_write(int tag, int val,
                                            bool mask) const {
    if (mask && tag >= 0) a.dir_loc[dir_at(tag, true)] = val;
  }

  // cache._next_addr: the trace word at ptr (clamped), -1 if exhausted
  __device__ __forceinline__ int next_addr(int ptr, bool& exhausted) const {
    const int p = min(max(ptr, 0), a.trace_len - 1);
    const int x = ld(a.trace, a.es_trace,
                     static_cast<int64_t>(i) * a.trace_len + p);
    exhausted = ptr >= a.trace_len || x < 0;
    return exhausted ? -1 : x;
  }
};

struct Probe {
  int set, way;   // the set, and the first way that holds the tag (0)
  bool hit;
};

// cache.l2_probe of tag t (a negative t probes nothing: set 0, no hit)
__device__ __forceinline__ Probe l2_probe(const Node& d, int t) {
  Probe p{t >= 0 ? t % d.a.l2_sets : 0, 0, false};
  if (t >= 0)
    for (int w = 0; w < d.a.l2_ways; ++w)
      if (d.l2_tag(p.set, w) == t) { p.way = w; p.hit = true; break; }
  return p;
}

// cache.l1_probe of L1 tag t1
__device__ __forceinline__ Probe l1_probe_tag(const Node& d, int t1) {
  Probe p{t1 >= 0 ? t1 % d.a.l1_sets : 0, 0, false};
  if (t1 >= 0)
    for (int w = 0; w < d.a.l1_ways; ++w)
      if (d.l1_tag(p.set, w) == t1) { p.way = w; p.hit = true; break; }
  return p;
}

__device__ __forceinline__ int l1_tag_of(const Phase1Args& a, int addr) {
  return addr >= 0 ? addr >> a.l1_shift : -1;
}

// An L1 set's victim: the first invalid way, else the first LRU minimum.
struct L1Victim {
  bool has_inv;
  int lru_way, way;
};

__device__ __forceinline__ L1Victim l1_victim(const Node& d, int s) {
  L1Victim v{false, 0, 0};
  int inv_way = 0, lru_min = 0;
  for (int w = 0; w < d.a.l1_ways; ++w) {
    if (!v.has_inv && d.l1_tag(s, w) < 0) { v.has_inv = true; inv_way = w; }
    const int l = ld(d.a.l1_lru, d.a.es_l1_lru, d.l1(s, w));
    if (w == 0 || l < lru_min) { lru_min = l; v.lru_way = w; }
  }
  v.way = v.has_inv ? inv_way : v.lru_way;
  return v;
}

// An L2 set's victim: the first invalid way, else the first minimum of
// lru + mig * 2^30 (so a migrating block goes last); all_mig when every
// way is pinned migrating.
struct L2Victim {
  bool has_inv, all_mig;
  int lru_way, way;
};

__device__ __forceinline__ L2Victim l2_victim(const Node& d, int s) {
  L2Victim v{false, true, 0, 0};
  int inv_way = 0, key_min = 0;
  for (int w = 0; w < d.a.l2_ways; ++w) {
    const int64_t k = d.l2(s, w);
    if (!v.has_inv && ld(d.a.l2_tag, d.a.es_l2_tag, k) < 0) {
      v.has_inv = true;
      inv_way = w;
    }
    const int mig = ld(d.a.l2_mig, d.a.es_l2_mig, k);
    v.all_mig = v.all_mig && mig > 0;
    // int32 arithmetic that wraps, as torch's
    const int key = static_cast<int>(
        static_cast<unsigned int>(ld(d.a.l2_lru, d.a.es_l2_lru, k)) +
        static_cast<unsigned int>(mig) * BIG);
    if (w == 0 || key < key_min) { key_min = key; v.lru_way = w; }
  }
  v.way = v.has_inv ? inv_way : v.lru_way;
  return v;
}

// cache.install_l1 (S3): masked L1 install with victim write-back
struct L1Install {
  int set, way;
  bool touch;
  Desc wb;
};

__device__ __forceinline__ L1Install install_l1(const Node& d, bool mask,
                                                int addr, int owner) {
  const Phase1Args& a = d.a;
  const int tag1 = l1_tag_of(a, mask ? addr : -1);
  const Probe p = l1_probe_tag(d, tag1);
  L1Install r{p.set, 0, false, Desc{false, 0, 0, 0, 0}};
  if (!mask) return r;
  const bool present = p.hit;
  const bool need = !p.hit;
  const L1Victim v = l1_victim(d, p.set);
  const bool vic_valid = need && !v.has_inv;
  const int vtag1 = d.l1_tag(p.set, v.way);
  const int vowner = ld(a.l1_owner, a.es_l1_owner, d.l1(p.set, v.way));
  const int vtag2 = vtag1 >= 0 ? vtag1 >> (a.l2_shift - a.l1_shift) : -1;
  // local write-back: does our own L2 still hold the victim's block?
  const bool wb_local = vic_valid && vowner == d.i;
  const Probe q = l2_probe(d, wb_local ? vtag2 : -1);
  d.bump(STAT_WB_MISS, wb_local && !q.hit);
  const bool wb_remote = vic_valid && vowner >= 0 && vowner != d.i;
  d.bump(STAT_WB_SENT, wb_remote);
  r.wb = Desc{wb_remote, MSG_WB, vowner, d.i, vtag2};
  r.way = present ? p.way : v.way;
  r.touch = true;
  put(a.l1_tag, a.es_l1_tag, d.l1(p.set, r.way), tag1);
  put(a.l1_owner, a.es_l1_owner, d.l1(p.set, r.way), owner);
  return r;
}

// cache.install_l2 (S5): masked L2 install with victim eviction; its
// directory writes are returned for the caller to make in its order
struct L2Install {
  bool ok, did;
  int set, way;
  Desc duv, dun;
  int vtag, vval;
  bool vlocal, nlocal;
};

__device__ __forceinline__ L2Install install_l2(const Node& d, bool mask,
                                                int tag2, int central) {
  const Phase1Args& a = d.a;
  const Probe p = l2_probe(d, mask ? tag2 : -1);
  L2Install r{false, false, p.set, 0, Desc{false, 0, 0, 0, 0},
              Desc{false, 0, 0, 0, 0}, 0, 0, false, false};
  if (!mask) return r;
  const bool present = p.hit;
  const bool need = !p.hit;
  const L2Victim v = l2_victim(d, p.set);
  const bool fail = need && !v.has_inv && v.all_mig;
  const bool go = need && !fail;
  const bool vic_valid = go && !v.has_inv;
  const int vtag = d.l2_tag(p.set, v.way);
  // victim directory delete (S4)
  const int homev = d.home(vtag, central);
  r.vlocal = vic_valid && homev == d.i;
  const bool vremote = vic_valid && !r.vlocal;
  const int cur_v = d.dir_read(vtag, r.vlocal);
  r.vtag = vtag;
  r.vval = cur_v == d.i ? -1 : cur_v;
  r.duv = Desc{vremote, MSG_DU, homev, -1, vtag};
  // write the new block
  if (go) {
    const int64_t k = d.l2(p.set, v.way);
    put(a.l2_tag, a.es_l2_tag, k, tag2);
    put(a.l2_mig, a.es_l2_mig, k, 0);
    put(a.l2_last, a.es_l2_last, k, -1);
    put(a.l2_streak, a.es_l2_streak, k, 0);
  }
  // new-owner directory update
  const int homen = d.home(tag2, central);
  r.nlocal = go && homen == d.i;
  r.dun = Desc{go && !r.nlocal, MSG_DU, homen, d.i, tag2};
  r.ok = present || go;
  r.did = go;
  r.way = v.way;
  d.bump(STAT_DIR_UPDATE, r.vlocal);
  d.bump(STAT_DIR_UPDATE, r.nlocal);
  d.bump(STAT_L2_INSTALL_DROP, fail);
  return r;
}

// cache._l1_install_would_wb: would install_l1 send a remote write-back?
__device__ __forceinline__ bool l1_install_would_wb(const Node& d, bool mask,
                                                   int addr) {
  const Probe p = l1_probe_tag(d, l1_tag_of(d.a, mask ? addr : -1));
  if (!mask || p.hit) return false;
  const L1Victim v = l1_victim(d, p.set);
  const int vowner = ld(d.a.l1_owner, d.a.es_l1_owner, d.l1(p.set, v.lru_way));
  return !v.has_inv && vowner >= 0 && vowner != d.i;
}

// cache._l2_install_du_count: DU packets install_l2 would enqueue
__device__ __forceinline__ int l2_install_du_count(const Node& d, bool mask,
                                                  int tag2, int central) {
  const Probe p = l2_probe(d, mask ? tag2 : -1);
  if (!mask || p.hit) return 0;
  const L2Victim v = l2_victim(d, p.set);
  const bool go = !(!v.has_inv && v.all_mig);
  const bool vic_valid = go && !v.has_inv;
  const int vtag = d.l2_tag(p.set, v.lru_way);
  const bool duv = vic_valid && d.home(vtag, central) != d.i;
  const bool dun = go && d.home(tag2, central) != d.i;
  return static_cast<int>(duv) + static_cast<int>(dun);
}

// cache.commit_queue (S2): append d0, d1, d2 in slot order to the node's
// packet ring; a descriptor that is not accepted (invalid ones included)
// is written to the sink slot send_queue, where the node's last such row
// stays; whole packets are dropped when the ring is full
__device__ __forceinline__ void commit_queue(const Node& d,
                                            const Desc (&ds)[3]) {
  const Phase1Args& a = d.a;
  const int qp = a.send_queue;
  const int qs = a.q_size[d.i], pk = a.pkt_ctr[d.i], qh = a.q_head[d.i];
  int off = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const Desc& x = ds[j];
    const bool ok = x.v && qs + off < qp;
    d.bump(STAT_SEND_DROP, x.v && !ok);
    const int pos = ok ? (qh + qs + off) % qp : qp;
    int32_t* row = a.q_desc +
                   (static_cast<int64_t>(d.i) * (qp + 1) + pos) * NUM_Q;
    row[0] = x.typ;
    row[1] = x.dst;
    row[2] = x.osrc;
    row[3] = x.tag;
    row[4] = (pk + off) & (a.pkt_wrap - 1);
    row[5] = FLITS_OF[min(max(x.typ, 0), 9)];
    off += ok;
  }
  a.q_size[d.i] = qs + off;
  a.pkt_ctr[d.i] = pk + off;
}

// cache.phase1a: the handler serves the head of the node's pending queue
__device__ __forceinline__ void phase1a(const Node& d, int knob_mig,
                                        int knob_mig_thr, int central) {
  const Phase1Args& a = d.a;
  const int i = d.i, nid = d.i;
  int32_t* pq = a.pc + static_cast<int64_t>(i) * a.pc_depth * NUM_P;
  const bool pc_valid = pq[P_VALID] > 0;
  const int typ = pq[P_TYP], src = pq[P_SRC], osrc = pq[P_OSRC],
            tag = pq[P_TAG];
  const bool p_req = pc_valid && (typ == MSG_REQ || typ == MSG_REQ_FWD);
  const bool p_ra = pc_valid && typ == MSG_RA;
  const bool p_da = pc_valid && typ == MSG_DA;
  const bool p_dr = pc_valid && typ == MSG_DR;
  const bool p_b2 = pc_valid && typ == MSG_B2;
  const bool p_wb = pc_valid && typ == MSG_WB;
  const bool p_ack = pc_valid && typ == MSG_MIG_ACK;
  const int st0 = a.st[i];
  const int qs = a.q_size[i];

  // shared L2 probe on the completion tag, masked by the head's type
  const Probe hp = l2_probe(d, (p_req || p_wb || p_ack) ? tag : -1);
  const int64_t hit_at = d.l2(hp.set, hp.way);

  // S14: defer until the send queue can hold the response
  int need;
  if (a.pc_depth > 1) {
    bool trig_p = false;
    if (p_req && hp.hit && knob_mig > 0 && osrc != nid &&
        ld(a.l2_mig, a.es_l2_mig, hit_at) == 0) {
      const int streak =
          ld(a.l2_last, a.es_l2_last, hit_at) == osrc
              ? ld(a.l2_streak, a.es_l2_streak, hit_at) + 1 : 1;
      trig_p = streak >= knob_mig_thr;
    }
    const bool ra_ok_p = p_ra && st0 == ST_WAIT_DATA;
    const bool ra_wb_p = l1_install_would_wb(d, ra_ok_p, a.pend_addr[i]);
    const int b2_du_p = l2_install_du_count(d, p_b2, tag, central);
    const bool dr_req_p = p_dr && st0 == ST_WAIT_DIR && osrc >= 0;
    need = static_cast<int>(p_req) + trig_p + ra_wb_p + p_da + dr_req_p +
           p_b2 + b2_du_p;
  } else {
    need = NEED_OF[min(max(typ, 0), 9)];
  }
  bool valid = pc_valid && qs + need <= a.send_queue;
  if (a.pc_depth > 1) {
    // guaranteed drain: a full queue fires its head even without space
    int cnt = 0;
    for (int k = 0; k < a.pc_depth; ++k) cnt += pq[k * NUM_P + P_VALID] > 0;
    valid = valid || (pc_valid && cnt >= a.pc_depth);
  }

  const bool is_req = valid && p_req, is_ra = valid && p_ra,
             is_nack = valid && typ == MSG_NACK, is_da = valid && p_da,
             is_dr = valid && p_dr, is_du = valid && typ == MSG_DU,
             is_wb = valid && p_wb, is_b2 = valid && p_b2,
             is_ack = valid && p_ack;
  const bool l2hit = (is_req || is_wb || is_ack) && hp.hit;

  Desc ds[3] = {Desc{false, 0, 0, 0, 0}, Desc{false, 0, 0, 0, 0},
                Desc{false, 0, 0, 0, 0}};
  int st = st0, ctr = a.ctr[i], imode = a.install_mode[i];

  // ---- REQ / REQ_FWD: remote access service + migration trigger ----
  const bool req_hit = is_req && l2hit;
  const bool req_miss = is_req && !l2hit;
  d.bump(STAT_REQ_RCVD, is_req);
  d.bump(STAT_REPLY_SENT, req_hit);
  merge(ds[0], req_hit, MSG_RA, osrc, osrc, tag);
  if (req_hit && knob_mig > 0 && osrc != nid &&
      ld(a.l2_mig, a.es_l2_mig, hit_at) == 0) {
    const int last = ld(a.l2_last, a.es_l2_last, hit_at);
    const int streak =
        last == osrc ? ld(a.l2_streak, a.es_l2_streak, hit_at) + 1 : 1;
    put(a.l2_last, a.es_l2_last, hit_at, osrc);
    put(a.l2_streak, a.es_l2_streak, hit_at,
        a.es_l2_streak < 4 ? min(streak, STREAK_MAX) : streak);
    const bool trig = streak >= knob_mig_thr;
    if (trig) put(a.l2_mig, a.es_l2_mig, hit_at, 1);
    merge(ds[1], trig, MSG_B2, osrc, nid, tag);
    d.bump(STAT_MIGRATIONS, trig);
  }
  if (req_miss) {
    const int32_t* ft = a.fwd_tag + static_cast<int64_t>(i) * a.fwd_entries;
    int hit = -1;
    for (int f = 0; f < a.fwd_entries; ++f)
      if (ft[f] == tag) { hit = f; break; }
    const int fwd_to =
        a.fwd_dst[static_cast<int64_t>(i) * a.fwd_entries + max(hit, 0)];
    const bool redir = hit >= 0 && fwd_to >= 0 && fwd_to != nid;
    merge(ds[0], redir, MSG_REQ_FWD, fwd_to, osrc, tag);
    merge(ds[0], !redir, MSG_NACK, osrc, osrc, tag);
    d.bump(STAT_REDIRECTION, redir);
    d.bump(STAT_TRAP, !redir);
  }

  // ---- RA (data reply) ----
  const bool ra_ok = is_ra && st == ST_WAIT_DATA;
  d.bump(STAT_REPLY_RCVD, ra_ok);
  d.bump(STAT_STRAY, is_ra && !ra_ok);
  const L1Install ins1 = install_l1(d, ra_ok, a.pend_addr[i], src);
  merge(ds[0], ins1.wb);
  if (ra_ok) st = ST_IDLE;

  // ---- NACK (trap reply) ----
  const bool nk_ok = is_nack && st == ST_WAIT_DATA;
  d.bump(STAT_STRAY, is_nack && !nk_ok);
  if (nk_ok) {
    st = ST_WAIT_MEM;
    ctr = a.mem_cycles;
    imode = INSTALL_L1_ONLY;
  }
  d.bump(STAT_MEM_REQ, nk_ok);

  // ---- DA (directory lookup at home, S6 reserve-on-miss) ----
  d.bump(STAT_DIR_SEARCH, is_da);
  const int owner0 = d.dir_read(tag, is_da);
  const bool reserve = is_da && (owner0 < 0 || owner0 == osrc);
  merge(ds[0], is_da, MSG_DR, osrc, reserve ? -1 : owner0, tag);

  // ---- DR (directory reply) ----
  const bool dr_ok = is_dr && st == ST_WAIT_DIR;
  d.bump(STAT_STRAY, is_dr && !dr_ok);
  const bool dr_req = dr_ok && osrc >= 0;
  const bool dr_mem = dr_ok && osrc < 0;
  merge(ds[0], dr_req, MSG_REQ, osrc, nid, tag);
  d.bump(STAT_REQ_MADE, dr_req);
  if (dr_req) {
    st = ST_WAIT_DATA;
    if (a.pc_depth > 1) ctr = a.req_timeout;  // arm the timeout
  }
  if (dr_mem) {
    st = ST_WAIT_MEM;
    ctr = a.mem_cycles;
    imode = INSTALL_L2;
  }
  d.bump(STAT_MEM_REQ, dr_mem);

  // ---- DU (directory update) ----
  d.bump(STAT_DIR_UPDATE, is_du);
  const int du_cur = d.dir_read(tag, is_du);
  const int du_val = osrc < 0 ? (du_cur == src ? -1 : du_cur) : osrc;

  // ---- WB (L1 victim write-back arriving at the block's L2 home) ----
  const bool wb_hit = is_wb && l2hit;
  d.bump(STAT_WB_RCVD, is_wb);
  d.bump(STAT_WB_MISS, is_wb && !l2hit);

  // ---- B2 (migration arrival) ----
  d.bump(STAT_MIGRATIONS_DONE, is_b2);
  const L2Install ins2 = install_l2(d, is_b2, tag, central);
  merge(ds[0], ins2.duv);
  merge(ds[1], ins2.dun);
  merge(ds[2], is_b2, MSG_MIG_ACK, src, ins2.ok ? nid : -1, tag);

  // ---- MIG_ACK (S13) ----
  if (is_ack && osrc >= 0 && l2hit &&
      ld(a.l2_mig, a.es_l2_mig, hit_at) > 0) {
    put(a.l2_tag, a.es_l2_tag, hit_at, -1);
    put(a.l2_mig, a.es_l2_mig, hit_at, 0);
  }
  if (is_ack && osrc >= 0) {
    const int p = a.fwd_ptr[i] % a.fwd_entries;
    const int64_t at = static_cast<int64_t>(i) * a.fwd_entries + p;
    a.fwd_tag[at] = tag;
    a.fwd_dst[at] = osrc;
    a.fwd_ptr[i] = p + 1;
  }
  if (is_ack && osrc < 0 && l2hit) {
    put(a.l2_mig, a.es_l2_mig, hit_at, 0);
    put(a.l2_streak, a.es_l2_streak, hit_at, 0);
  }

  // ---- directory writes (one handler per node, same entry => same home
  //      => same node) ----
  const bool da_res = is_da && reserve;
  if (da_res) d.dir_write(tag, osrc, true);
  else if (is_du) d.dir_write(tag, du_val, true);
  else d.dir_write(ins2.vtag, ins2.vval, ins2.vlocal);
  d.dir_write(tag, nid, ins2.nlocal);

  // ---- the single 1a LRU touch site ----
  const bool l2touch = req_hit || wb_hit || ins2.did;
  const int clock = a.lru_clock[i] + (l2touch || ins1.touch);
  if (l2touch)
    put(a.l2_lru, a.es_l2_lru,
        ins2.did ? d.l2(ins2.set, ins2.way) : hit_at, clock);
  if (ins1.touch)
    put(a.l1_lru, a.es_l1_lru, d.l1(ins1.set, ins1.way), clock);

  a.st[i] = st;
  a.ctr[i] = ctr;
  a.install_mode[i] = imode;
  a.lru_clock[i] = clock;
  // pop the served head: shift the queue down one slot
  if (valid) {
    for (int k = 0; k < (a.pc_depth - 1) * NUM_P; ++k) pq[k] = pq[k + NUM_P];
    for (int f = 0; f < NUM_P; ++f) pq[(a.pc_depth - 1) * NUM_P + f] = 0;
  }
  commit_queue(d, ds);
}

// cache.phase1b: the trace-driven FSM
__device__ __forceinline__ void phase1b(const Node& d, int central) {
  const Phase1Args& a = d.a;
  const int i = d.i, nid = d.i;
  const int st0 = a.st[i], pend0 = a.pend_addr[i], imode0 = a.install_mode[i];
  int st = st0, ctr = a.ctr[i], tr_ptr = a.tr_ptr[i], pend = pend0,
      imode = imode0;
  Desc ds[3] = {Desc{false, 0, 0, 0, 0}, Desc{false, 0, 0, 0, 0},
                Desc{false, 0, 0, 0, 0}};
  bool exhausted;
  const int addr = d.next_addr(tr_ptr, exhausted);
  // S14: per-state send-queue space gates the FSM's fire points
  const int space = a.send_queue - a.q_size[i];

  // ---- IDLE: consume one trace address ----
  const bool idle = st0 == ST_IDLE;
  const bool consume = idle && !exhausted;
  const Probe p1 = l1_probe_tag(d, l1_tag_of(a, consume ? addr : -1));
  const bool l1hit = consume && p1.hit;
  const bool l1miss = consume && !p1.hit;
  d.bump(STAT_L1_HITS, l1hit);
  d.bump(STAT_L1_MISSES, l1miss);
  tr_ptr += consume;
  if (l1miss) pend = addr;
  if (idle && exhausted) st = ST_DONE;
  if (l1miss) {
    st = ST_L1_WAIT;
    ctr = a.l1_miss_cycles;
  }

  // ---- L1_WAIT: countdown then local-L2 probe / directory ----
  const bool l1w = st0 == ST_L1_WAIT;
  if (l1w) ctr -= 1;
  const bool l1w_fire0 = l1w && ctr <= 0;
  const bool l1w_fire = l1w_fire0 && space >= 1;
  if (l1w_fire0 && !l1w_fire) ctr = 1;
  const int tag2 = pend0 >= 0 ? pend0 >> a.l2_shift : -1;
  const Probe p2 = l2_probe(d, l1w_fire ? tag2 : -1);
  const bool l2hit = l1w_fire && p2.hit;
  const bool l2miss = l1w_fire && !p2.hit;
  d.bump(STAT_L2_LOCAL_HITS, l2hit);
  d.bump(STAT_L2_LOCAL_MISSES, l2miss);
  if (l2hit) {
    st = ST_L2_WAIT;
    ctr = a.l2_hit_cycles;
  }
  const int home = d.home(tag2, central);
  const bool inl = l2miss && home == nid;  // S8
  const bool remote = l2miss && !inl;
  d.bump(STAT_DIR_SEARCH, inl);
  const int owner0 = d.dir_read(tag2, inl);
  const bool inl_req = inl && owner0 >= 0 && owner0 != nid;
  const bool inl_mem = inl && !inl_req;
  merge(ds[0], inl_req, MSG_REQ, owner0, nid, tag2);
  d.bump(STAT_REQ_MADE, inl_req);
  if (inl_req) st = ST_WAIT_DATA;
  if (inl_mem) {
    st = ST_WAIT_MEM;
    ctr = a.mem_cycles;
    imode = INSTALL_L2;
  }
  d.bump(STAT_MEM_REQ, inl_mem);
  d.dir_write(tag2, nid, inl_mem);  // reserve (S6)
  merge(ds[0], remote, MSG_DA, home, nid, tag2);
  if (remote) st = ST_WAIT_DIR;
  if (a.pc_depth > 1 && (remote || inl_req)) ctr = a.req_timeout;

  // ---- L2_WAIT: countdown then move the block into L1 ----
  const bool l2w = st0 == ST_L2_WAIT;
  if (l2w) ctr -= 1;
  const bool l2w_fire0 = l2w && ctr <= 0;
  const bool l2w_fire = l2w_fire0 && space >= 1;
  if (l2w_fire0 && !l2w_fire) ctr = 1;
  const Probe pf = l2_probe(d, l2w_fire ? tag2 : -1);
  const bool l2f_touch = l2w_fire && pf.hit;

  // ---- WAIT_MEM: countdown then install ----
  const bool wm = st0 == ST_WAIT_MEM;
  if (wm) ctr -= 1;
  const bool wm_fire0 = wm && ctr <= 0;
  const bool wm_fire = wm_fire0 && space >= 3;
  if (wm_fire0 && !wm_fire) ctr = 1;
  const bool wm_wait = wm && !wm_fire0;
  const bool wm_l2 = wm_fire && imode0 == INSTALL_L2;
  const bool wm_l1o = wm_fire && imode0 == INSTALL_L1_ONLY;
  const L2Install ins2 = install_l2(d, wm_l2, tag2, central);
  merge(ds[0], ins2.duv);
  merge(ds[1], ins2.dun);
  d.dir_write(ins2.vtag, ins2.vval, ins2.vlocal);
  d.dir_write(tag2, nid, ins2.nlocal);

  // ---- WAIT_DIR / WAIT_DATA transaction timeout (pc_depth > 1) ----
  const bool wt = st0 == ST_WAIT_DIR || st0 == ST_WAIT_DATA;
  if (a.pc_depth > 1) {
    if (wt) ctr -= 1;
    const bool rt_fire0 = wt && ctr <= 0;
    const bool rt_fire = rt_fire0 && space >= 1;
    if (rt_fire0 && !rt_fire) ctr = 1;
    merge(ds[0], rt_fire, MSG_DA, home, nid, tag2);
    if (rt_fire) {
      st = ST_WAIT_DIR;
      ctr = a.req_timeout;
    }
  }

  // ---- hit-under-miss (S7) in WAIT_DIR / WAIT_DATA / counting WAIT_MEM ----
  bool h_exh;
  const int h_addr = d.next_addr(tr_ptr, h_exh);
  const bool h_try = (wt || wm_wait) && !h_exh;
  const Probe ph = l1_probe_tag(d, l1_tag_of(a, h_try ? h_addr : -1));
  const bool hum = h_try && ph.hit;
  d.bump(STAT_L1_HITS, hum);
  tr_ptr += hum;

  // ---- touch site 2 (IDLE L1 hit | L2_WAIT L2 touch | install_l2's new
  //      block | hit-under-miss L1 touch) ----
  const bool t2_l1 = l1hit || hum;
  const bool t2_l2 = l2f_touch || ins2.did;
  int clock = a.lru_clock[i] + (t2_l1 || t2_l2);
  if (t2_l1)
    put(a.l1_lru, a.es_l1_lru,
        l1hit ? d.l1(p1.set, p1.way) : d.l1(ph.set, ph.way), clock);
  if (t2_l2)
    put(a.l2_lru, a.es_l2_lru,
        l2f_touch ? d.l2(pf.set, pf.way) : d.l2(ins2.set, ins2.way), clock);

  // ---- install_l1 (touch site 3): L2_WAIT refill, WAIT_MEM installs ----
  const bool il1 = l2w_fire || wm_fire;
  const L1Install ins1 = install_l1(d, il1, pend0, wm_l1o ? -1 : nid);
  merge(ds[2], ins1.wb);
  clock += ins1.touch;
  if (ins1.touch)
    put(a.l1_lru, a.es_l1_lru, d.l1(ins1.set, ins1.way), clock);
  if (il1) st = ST_IDLE;

  a.st[i] = st;
  a.ctr[i] = ctr;
  a.tr_ptr[i] = tr_ptr;
  a.pend_addr[i] = pend;
  a.install_mode[i] = imode;
  a.lru_clock[i] = clock;
  commit_queue(d, ds);
}

__global__ void __launch_bounds__(TILE)
phase1_cache_kernel(const Phase1Args a) {
  __shared__ unsigned int s_sum[NUM_STATS];
  const int t = threadIdx.x;
  const int i = blockIdx.x * TILE + t;
  for (int k = t; k < NUM_STATS; k += TILE) s_sum[k] = 0;
  __syncthreads();

  unsigned int cnt[NUM_STATS];
#pragma unroll
  for (int k = 0; k < NUM_STATS; ++k) cnt[k] = 0;
  if (i < a.n) {
    const Node d{a, i, cnt};
    const int central = *a.knob_central;
    phase1a(d, *a.knob_mig, *a.knob_mig_thr, central);
    phase1b(d, central);
  }

  // ---- statistics: warp sums, CTA sums, one atomic a statistic ----
#pragma unroll
  for (int k = 0; k < NUM_STATS; ++k) {
    const unsigned int x = __reduce_add_sync(0xffffffffu, cnt[k]);
    if ((t & 31) == 0 && x) atomicAdd(&s_sum[k], x);
  }
  __syncthreads();
  for (int k = t; k < NUM_STATS; k += TILE)
    if (s_sum[k])
      atomicAdd(reinterpret_cast<unsigned int*>(a.stats) + k, s_sum[k]);
}

}  // namespace

extern "C" int phase1_cache(const Phase1Args* args, void* stream) {
  const Phase1Args& a = *args;   // a.n >= 1: the wrapper checks it
  const int blocks = (a.n + TILE - 1) / TILE;
  phase1_cache_kernel<<<blocks, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
