// Native event-stream preprocessing for the device reachability engine.
//
// The device walk consumes flat int arrays (jepsen_tpu/checkers/events.py);
// building them involves two inherently-sequential scans that are the
// host-side hot path on 100k-op histories:
//
//   1. slot assignment: lowest-free-slot seat assignment over the sorted
//      invoke/return event stream (interval-graph greedy coloring — the
//      packed-config representation upstream keeps in
//      knossos/src/knossos/linear/config.clj [U]);
//   2. the returns-only projection with per-return pending-op snapshots.
//
// Python loops cost ~0.4 s at 147k events — comparable to the whole
// device walk after the Pallas kernel; here they are ~2 ms. Built on
// demand with g++ like native/wgl.cpp; the Python implementations remain
// as fallback.

#include <algorithm>
#include <cstdint>
#include <deque>
#include <queue>
#include <unordered_map>
#include <vector>
#include <functional>

extern "C" {

// Events must be pre-sorted by rank. kind: 0 = invoke, 1 = return.
// entry[e] is the analysis-entry index of event e. Writes out_slot[E];
// returns the number of slots used (W), or -1 if it would exceed
// max_slots.
int64_t jt_assign_slots(int64_t E, const int32_t* kind,
                        const int32_t* entry, int64_t n_entries,
                        int32_t max_slots, int32_t* out_slot) {
    std::priority_queue<int32_t, std::vector<int32_t>,
                        std::greater<int32_t>> free_slots;
    std::vector<int32_t> slot_of(static_cast<size_t>(n_entries), -1);
    int32_t hi = 0;
    for (int64_t e = 0; e < E; ++e) {
        if (kind[e] == 0) {
            int32_t s;
            if (!free_slots.empty()) {
                s = free_slots.top();
                free_slots.pop();
            } else {
                s = hi++;
                if (hi > max_slots) return -1;
            }
            slot_of[static_cast<size_t>(entry[e])] = s;
            out_slot[e] = s;
        } else {
            int32_t s = slot_of[static_cast<size_t>(entry[e])];
            out_slot[e] = s;
            free_slots.push(s);
        }
    }
    return hi;
}

// Project the event stream to its return events. Writes ret_slot[R],
// slot_ops[R*W] (the full pending map at each return, -1 = free),
// ret_event[R], ret_entry[R]; returns R (the number of returns).
int64_t jt_returns_view(int64_t E, const int32_t* kind,
                        const int32_t* slot, const int32_t* opid,
                        const int32_t* entry, int32_t W,
                        int32_t* ret_slot, int32_t* slot_ops,
                        int32_t* ret_event, int32_t* ret_entry) {
    std::vector<int32_t> cur(static_cast<size_t>(W), -1);
    int64_t r = 0;
    for (int64_t e = 0; e < E; ++e) {
        if (kind[e] == 0) {                       // invoke
            cur[static_cast<size_t>(slot[e])] = opid[e];
        } else if (kind[e] == 1) {                // return
            int32_t s = slot[e];
            for (int32_t w = 0; w < W; ++w)
                slot_ops[r * W + w] = cur[static_cast<size_t>(w)];
            ret_slot[r] = s;
            ret_event[r] = static_cast<int32_t>(e);
            ret_entry[r] = entry[e];
            cur[static_cast<size_t>(s)] = -1;
            ++r;
        }
    }
    return r;
}

// Batched per-key event building for the keyed (`independent`) batch
// checker: ONE call replaces, for every key at once, the per-key
// event-sort + noop-crash drop + slot assignment + returns projection
// that cost ~1.3 s of Python/ctypes plumbing at 4096 keys.
//
// Inputs are the keys' packed entry arrays concatenated (entry_off[K+1]
// offsets): inv_rank / ret_rank (ret_rank < 0 = crashed, forever
// pending), opid already remapped into the UNION alphabet, and the
// union-level noop flags (crashed entries whose op is a no-op in every
// state are provably irrelevant and dropped, as in events.build).
//
// Outputs (flat over all keys, preallocated by the caller):
//   ret_slot[R_total], slot_ops[R_total * w_cap] (-1 = free slot),
//   pend[R_total] (pending count incl. the returning op — the gate
//   ladder's exact pass bound), key_W[K] (slots used; -1 = overflow
//   beyond max_slots), key_R[K] (returns emitted), ret_entry[R_total]
//   (LOCAL entry index within the key, for failure reporting).
// Returns R_total.
int64_t jt_build_keyed(int64_t K, const int64_t* entry_off,
                       const int32_t* inv_rank, const int32_t* ret_rank,
                       const int32_t* opid, const uint8_t* crashed,
                       const uint8_t* noop_op, int32_t max_slots,
                       int32_t w_cap,
                       int32_t* ret_slot, int32_t* slot_ops,
                       int32_t* pend, int32_t* key_W, int32_t* key_R,
                       int32_t* ret_entry) {
    struct Ev { int32_t rank; int32_t entry; uint8_t is_ret; };
    std::vector<Ev> evs;
    std::vector<int32_t> slot_of, cur;
    int64_t r_out = 0;
    for (int64_t k = 0; k < K; ++k) {
        const int64_t lo = entry_off[k], hi = entry_off[k + 1];
        const int64_t n = hi - lo;
        evs.clear();
        evs.reserve(static_cast<size_t>(2 * n));
        for (int64_t i = lo; i < hi; ++i) {
            const bool crash = crashed[i] != 0;
            if (crash && noop_op[opid[i]]) continue;    // droppable
            const int32_t e = static_cast<int32_t>(i - lo);
            evs.push_back({inv_rank[i], e, 0});
            if (!crash) evs.push_back({ret_rank[i], e, 1});
        }
        std::sort(evs.begin(), evs.end(),
                  [](const Ev& a, const Ev& b) { return a.rank < b.rank; });
        slot_of.assign(static_cast<size_t>(n), -1);
        cur.assign(static_cast<size_t>(w_cap), -1);
        std::priority_queue<int32_t, std::vector<int32_t>,
                            std::greater<int32_t>> free_slots;
        int32_t hi_slot = 0, n_pend = 0, n_ret = 0;
        bool overflow = false;
        const int64_t r_base = r_out;
        for (const Ev& ev : evs) {
            if (!ev.is_ret) {                           // invoke
                int32_t s;
                if (!free_slots.empty()) {
                    s = free_slots.top();
                    free_slots.pop();
                } else {
                    s = hi_slot++;
                    if (hi_slot > max_slots || hi_slot > w_cap) {
                        overflow = true;
                        break;
                    }
                }
                slot_of[static_cast<size_t>(ev.entry)] = s;
                cur[static_cast<size_t>(s)] = opid[lo + ev.entry];
                ++n_pend;
            } else {                                    // return
                const int32_t s = slot_of[static_cast<size_t>(ev.entry)];
                int32_t* row = slot_ops + (r_base + n_ret) * w_cap;
                for (int32_t w = 0; w < w_cap; ++w) row[w] = cur[w];
                ret_slot[r_base + n_ret] = s;
                pend[r_base + n_ret] = n_pend;
                ret_entry[r_base + n_ret] = ev.entry;
                cur[static_cast<size_t>(s)] = -1;
                free_slots.push(s);
                --n_pend;
                ++n_ret;
            }
        }
        if (overflow) {
            key_W[k] = -1;
            key_R[k] = 0;
            continue;                   // r_out unchanged: rows reused
        }
        key_W[k] = hi_slot;
        key_R[k] = n_ret;
        r_out = r_base + n_ret;
    }
    return r_out;
}

// Dense-reachability returns walk on bit-packed config sets — the
// online monitor's host-side engine (jepsen_tpu/checkers/online.py).
// The config set R[s] is a bitset over pending-set masks m (bit m of
// word m/64), one row per model state: a few words total at monitor
// scale, so word-parallel C++ beats both the per-return NumPy fixpoint
// (~170 us/return) and a jitted XLA CPU walk (~19 us/return + ~ms of
// dispatch per flush) by orders of magnitude.
//
// Semantics match reach._walk_returns / online._walk_return exactly:
// per return, Gauss-Seidel fire passes to the fixpoint (firing slot j
// maps configs with mask-bit j clear into their transition images with
// bit j set), then projection on the returning slot (keep configs that
// fired it, clearing the bit). Returns the index of the first return
// that emptied the set, or -1; R is updated in place (on death it
// holds the empty set).
int64_t jt_walk_dense(int32_t S, int32_t W, int64_t n_words,
                      const int32_t* T, int32_t n_ops,
                      uint64_t* R,
                      int64_t L, const int32_t* ret_slot,
                      const int32_t* rows) {
    const int64_t M_bits = n_words * 64;
    // clear_mask[j][w]: bit m set iff mask m has slot-bit j CLEAR
    std::vector<uint64_t> clear_mask(static_cast<size_t>(W) * n_words);
    for (int32_t j = 0; j < W; ++j) {
        const int64_t bitj = int64_t(1) << j;
        for (int64_t w = 0; w < n_words; ++w) {
            uint64_t v = 0;
            for (int b = 0; b < 64; ++b) {
                const int64_t m = w * 64 + b;
                if (m < M_bits && !(m & bitj)) v |= uint64_t(1) << b;
            }
            clear_mask[static_cast<size_t>(j) * n_words + w] = v;
        }
    }
    std::vector<uint64_t> src(static_cast<size_t>(n_words));
    std::vector<uint64_t> tmp(static_cast<size_t>(S) * n_words);
    for (int64_t r = 0; r < L; ++r) {
        // fire to fixpoint (Gauss-Seidel in place; monotone)
        bool changed = true;
        while (changed) {
            changed = false;
            for (int32_t j = 0; j < W; ++j) {
                const int32_t o = rows[r * W + j];
                if (o < 0) continue;
                const int64_t bitj = int64_t(1) << j;
                const int64_t w_off = bitj >> 6;
                const int b_off = static_cast<int>(bitj & 63);
                const uint64_t* cm =
                    &clear_mask[static_cast<size_t>(j) * n_words];
                for (int32_t s = 0; s < S; ++s) {
                    const int32_t t = T[s * n_ops + o];
                    if (t < 0) continue;
                    uint64_t* Rs = R + s * n_words;
                    uint64_t* Rt = R + t * n_words;
                    for (int64_t w = 0; w < n_words; ++w)
                        src[static_cast<size_t>(w)] = Rs[w] & cm[w];
                    // OR the src bits shifted UP by bitj into Rt
                    for (int64_t w = n_words - 1; w >= w_off; --w) {
                        uint64_t v = src[static_cast<size_t>(w - w_off)]
                                     << b_off;
                        if (b_off && w - w_off - 1 >= 0)
                            v |= src[static_cast<size_t>(w - w_off - 1)]
                                 >> (64 - b_off);
                        if (v & ~Rt[w]) {
                            Rt[w] |= v;
                            changed = true;
                        }
                    }
                }
            }
        }
        // projection on the returning slot
        const int32_t jr = ret_slot[r];
        if (jr >= 0) {
            const int64_t bitj = int64_t(1) << jr;
            const int64_t w_off = bitj >> 6;
            const int b_off = static_cast<int>(bitj & 63);
            const uint64_t* cm =
                &clear_mask[static_cast<size_t>(jr) * n_words];
            bool any = false;
            for (int32_t s = 0; s < S; ++s) {
                const uint64_t* Rs = R + s * n_words;
                uint64_t* out = &tmp[static_cast<size_t>(s) * n_words];
                for (int64_t w = 0; w < n_words; ++w) {
                    const int64_t wh = w + w_off;
                    uint64_t kept_lo = 0, kept_hi = 0;
                    if (wh < n_words) kept_lo = Rs[wh] & ~cm[wh];
                    if (b_off && wh + 1 < n_words)
                        kept_hi = Rs[wh + 1] & ~cm[wh + 1];
                    uint64_t v = kept_lo >> b_off;
                    if (b_off) v |= kept_hi << (64 - b_off);
                    out[w] = v;
                    any |= (v != 0);
                }
            }
            std::copy(tmp.begin(),
                      tmp.begin() + static_cast<size_t>(S) * n_words, R);
            if (!any) return r;
        }
    }
    return -1;
}

// Benchmark history generator (fixtures.gen_packed): the tick-loop
// simulation of fixtures.gen_history for the register/cas kinds,
// emitting packed per-entry arrays directly — no Python Op objects, so
// a 10M-op benchmark input builds in well under a second instead of
// ~4 minutes. Linearizable by construction exactly like the Python
// generator: each op commits atomically at a random instant between
// its invocation and response; failed CAS attempts are dropped (the
// post-hoc analysis strips them), and their event ranks stay consumed
// so real-time ordering matches a full history's.
//
// Op identity encoding (decoded by fixtures.gen_packed):
//   read observing None -> 0; read observing v -> 1 + v;
//   write v -> 1 + V + v; cas [a, b] -> 1 + 2V + a*V + b.
// Returns the number of entries written (<= n_ops).

namespace {
struct SplitMix64 {
    std::uint64_t s;
    explicit SplitMix64(std::uint64_t seed) : s(seed) {}
    std::uint64_t next() {
        std::uint64_t z = (s += 0x9E3779B97F4A7C15ull);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    // uniform in [0, n) (n < 2^31; modulo bias is irrelevant here)
    int64_t below(int64_t n) { return static_cast<int64_t>(next() % n); }
    double unit() { return (next() >> 11) * 0x1.0p-53; }
};
}  // namespace

int64_t jt_gen_history(int64_t seed, int64_t n_ops, int32_t processes,
                       int32_t values, int32_t kind,  // 0=register 1=cas
                       int32_t* inv_ev, int32_t* ret_ev, int32_t* opid,
                       int32_t* proc) {
    SplitMix64 rng(static_cast<std::uint64_t>(seed) * 0x9E3779B97F4A7C15ull
                   + 0x243F6A8885A308D3ull);
    const int32_t V = values;
    struct Pend {
        int32_t stage = 0;      // 0 idle, 1 invoked, 2 committed
        int32_t inv_rank = 0;
        int32_t oid = 0;        // identity (read identity set at commit)
        bool okay = true;
    };
    std::vector<Pend> pend(static_cast<std::size_t>(processes));
    int32_t reg = -1;                                  // None
    int64_t invoked = 0, out = 0;
    int32_t ev = 0;
    int64_t live = 0;
    while (invoked < n_ops || live > 0) {
        const int64_t p = rng.below(processes);
        Pend& st = pend[static_cast<std::size_t>(p)];
        if (st.stage == 0) {
            if (invoked >= n_ops) continue;
            // choose an op (identity finalized at commit for reads)
            const double r = rng.unit();
            if (kind == 1 ? (r < 0.34) : (r < 0.5)) {
                st.oid = -1;                           // read, value TBD
            } else if (kind == 1 && r >= 0.67) {
                const int32_t a = static_cast<int32_t>(rng.below(V));
                const int32_t b = static_cast<int32_t>(rng.below(V));
                st.oid = 1 + 2 * V + a * V + b;
            } else {
                const int32_t v = static_cast<int32_t>(rng.below(V));
                st.oid = 1 + V + v;
            }
            st.inv_rank = ev++;
            st.stage = 1;
            ++invoked;
            ++live;
        } else if (st.stage == 1) {
            // commit atomically against the live register
            st.okay = true;
            if (st.oid == -1) {                        // read
                st.oid = (reg < 0) ? 0 : 1 + reg;
            } else if (st.oid >= 1 + 2 * V) {          // cas
                const int32_t enc = st.oid - (1 + 2 * V);
                const int32_t a = enc / V, b = enc % V;
                if (reg == a) reg = b;
                else st.okay = false;
            } else {                                   // write
                reg = st.oid - (1 + V);
            }
            st.stage = 2;
        } else {
            const int32_t rr = ev++;
            if (st.okay) {                             // failed ops drop
                inv_ev[out] = st.inv_rank;
                ret_ev[out] = rr;
                opid[out] = st.oid;
                proc[out] = static_cast<int32_t>(p);
                ++out;
            }
            st.stage = 0;
            --live;
        }
    }
    return out;
}

// ---------------------------------------------------------------------------
// Streaming monitor core (jepsen_tpu/checkers/online.py NativeStreamEngine):
// the per-op bookkeeping of the incremental linearizability monitor —
// slot assignment, settle-queue snapshots, and the settled-returns walk —
// in C++, fed in per-flush BATCHES. Profiling showed the monitor's cost
// was ~95% Python object churn (per-return snapshot lists, per-member
// interning, per-op dict traffic) and ~5% actual walking; this moves the
// churn to C++ and leaves Python only value interning (model-dependent)
// and the carried config set R (re-encoded on memo growth).
//
// Semantics mirror online.IncrementalEngine exactly (differential-tested):
//   invoke  -> lowest-free-slot binding (error on overflow/double invoke)
//   ok      -> settle item {binding, live-snapshot, crashed-count};
//              slot freed after the snapshot
//   fail    -> stripped (slot freed, never walked)
//   info    -> crashed: binding holds its slot forever, joins every later
//              return's pending map via the crashed-count prefix
// An item settles when every snapshot member has resolved; settled items
// are walked through jt_walk_dense in one batch per advance call.

namespace {

struct JtBind {
    int32_t slot;
    int8_t status;      // 0 pending, 1 ok, 2 fail, 3 crashed
    int32_t oid;        // resolved transition id (alphabet, append-only)
    int32_t wild;       // wildcard id for the unsettled-tail alarm
};

struct JtItem {
    int32_t b;          // returning binding index
    int32_t ncr;        // crashed-list length at feed time
    int32_t snap_off;   // into snap_pool
    int32_t snap_len;
};

struct JtMonitor {
    int32_t max_slots;
    int32_t W = 1;
    std::priority_queue<int32_t, std::vector<int32_t>,
                        std::greater<int32_t>> free_slots;
    int32_t hi = 0;
    std::vector<JtBind> binds;
    std::unordered_map<int64_t, int32_t> live;   // proc -> bind index
    std::vector<int32_t> crashed;                // bind indices
    std::deque<JtItem> queue;
    std::vector<int32_t> snap_pool;
    int64_t settled = 0;

    bool rows_for(const JtItem& it, int32_t* rows, bool wildcards) const {
        // materialize the item's pending map; returns false when a
        // member is unresolved (not settleable) unless wildcards
        // (tail-alarm mode: unresolved walks as crashed-at-invoke)
        for (int32_t j = 0; j < W; ++j) rows[j] = -1;
        for (int32_t k = 0; k < it.snap_len; ++k) {
            const JtBind& x = binds[static_cast<size_t>(
                snap_pool[static_cast<size_t>(it.snap_off) + k])];
            if (x.status == 0) {
                if (!wildcards) return false;
                rows[x.slot] = x.wild;
                continue;
            }
            if (x.status == 2) continue;             // fail: stripped
            rows[x.slot] = x.oid;
        }
        for (int32_t k = 0; k < it.ncr; ++k) {
            const JtBind& x = binds[static_cast<size_t>(crashed[k])];
            rows[x.slot] = x.oid;
        }
        const JtBind& rb = binds[static_cast<size_t>(it.b)];
        rows[rb.slot] = rb.oid;
        return true;
    }
};

}  // namespace

void* jt_mon_new(int32_t max_slots) {
    auto* m = new JtMonitor();
    m->max_slots = max_slots;
    return m;
}

void jt_mon_free(void* h) { delete static_cast<JtMonitor*>(h); }

// Feed a batch of ops. type: 0 invoke, 1 ok, 2 fail, 3 info; oid[i] is
// the resolved transition id for ok/info, the WILDCARD id for invoke
// (used only by the tail alarm), -1 for fail. The caller has already
// dropped nemesis ops and completions without a live invoke. Returns
// the (possibly grown) slot width W, or -1 on double invoke, -2 on
// slot overflow — both permanent-fallback conditions for the caller.
int64_t jt_mon_feed(void* h, int64_t n, const int32_t* type,
                    const int64_t* proc, const int32_t* oid) {
    auto* m = static_cast<JtMonitor*>(h);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p = proc[i];
        switch (type[i]) {
        case 0: {                                    // invoke
            if (m->live.count(p)) return -1;
            int32_t slot;
            if (!m->free_slots.empty()) {
                slot = m->free_slots.top();
                m->free_slots.pop();
            } else {
                slot = m->hi++;
            }
            if (slot >= m->max_slots) return -2;
            if (slot >= m->W) m->W = slot + 1;
            m->live[p] = static_cast<int32_t>(m->binds.size());
            m->binds.push_back({slot, 0, -1, oid[i]});
            break;
        }
        case 1: {                                    // ok
            auto it = m->live.find(p);
            if (it == m->live.end()) break;
            const int32_t bi = it->second;
            m->live.erase(it);
            JtBind& b = m->binds[static_cast<size_t>(bi)];
            b.status = 1;
            b.oid = oid[i];
            const int32_t off =
                static_cast<int32_t>(m->snap_pool.size());
            for (const auto& kv : m->live)
                m->snap_pool.push_back(kv.second);
            m->queue.push_back({bi,
                                static_cast<int32_t>(m->crashed.size()),
                                off,
                                static_cast<int32_t>(
                                    m->snap_pool.size()) - off});
            m->free_slots.push(b.slot);
            break;
        }
        case 2: {                                    // fail: stripped
            auto it = m->live.find(p);
            if (it == m->live.end()) break;
            JtBind& b = m->binds[static_cast<size_t>(it->second)];
            m->live.erase(it);
            b.status = 2;
            m->free_slots.push(b.slot);
            break;
        }
        case 3: {                                    // info: crashed
            auto it = m->live.find(p);
            if (it == m->live.end()) break;
            const int32_t bi = it->second;
            m->live.erase(it);
            JtBind& b = m->binds[static_cast<size_t>(bi)];
            b.status = 3;
            b.oid = oid[i];
            m->crashed.push_back(bi);                // slot held forever
            break;
        }
        default:
            break;
        }
    }
    return m->W;
}

// Walk every currently-settleable queued return through jt_walk_dense,
// dequeuing them. R is the carried config set, bit-packed
// [S, n_words] with M = 2^W mask bits, updated in place. Returns the
// number of returns walked; *out_dead_bind is the violating binding
// index (walking stopped there) or -1.
int64_t jt_mon_advance(void* h, const int32_t* T, int32_t S,
                       int32_t n_ops, uint64_t* R, int64_t n_words,
                       int32_t* out_dead_bind) {
    auto* m = static_cast<JtMonitor*>(h);
    *out_dead_bind = -1;
    std::vector<int32_t> rows;
    std::vector<int32_t> slots;
    std::vector<int32_t> bind_of;
    std::vector<int32_t> one(static_cast<size_t>(m->W));
    while (!m->queue.empty()) {
        const JtItem& it = m->queue.front();
        if (!m->rows_for(it, one.data(), false)) break;
        rows.insert(rows.end(), one.begin(), one.end());
        slots.push_back(m->binds[static_cast<size_t>(it.b)].slot);
        bind_of.push_back(it.b);
        m->queue.pop_front();
    }
    if (slots.empty()) return 0;
    const int64_t L = static_cast<int64_t>(slots.size());
    const int64_t dead = jt_walk_dense(S, m->W, n_words, T, n_ops, R,
                                       L, slots.data(), rows.data());
    if (dead >= 0) {
        *out_dead_bind = bind_of[static_cast<size_t>(dead)];
        m->settled += dead + 1;
        return dead + 1;
    }
    m->settled += L;
    return L;
}

// Pop every currently-settleable queued return WITHOUT walking it:
// fills rows [cap, W], slots [cap], binds [cap]; returns the count.
// The device-resident session engine drains here and walks the block
// on the accelerator (jepsen_tpu/serve/session.py) — the settle
// discipline stays this monitor's, only the walk moves off-host.
// The native settled counter advances for every POPPED item (on a
// mid-block death the engine's own Python counter — which stops at
// the death index — is the authoritative one); DEATH handling is
// entirely the caller's.
int64_t jt_mon_drain(void* h, int64_t cap, int32_t* rows,
                     int32_t* slots, int32_t* binds_out) {
    auto* m = static_cast<JtMonitor*>(h);
    int64_t n = 0;
    while (!m->queue.empty() && n < cap) {
        const JtItem& it = m->queue.front();
        if (!m->rows_for(it, rows + n * m->W, false)) break;
        slots[n] = m->binds[static_cast<size_t>(it.b)].slot;
        binds_out[n] = it.b;
        m->queue.pop_front();
        ++n;
    }
    m->settled += n;
    return n;
}

// Export the first K unsettled queue items for the tail alarm
// (unresolved members as their crashed-at-invoke wildcards). Fills
// rows [K, W], slots [K], binds [K]; returns the count.
int64_t jt_mon_tail(void* h, int64_t K, int32_t* rows, int32_t* slots,
                    int32_t* binds_out) {
    auto* m = static_cast<JtMonitor*>(h);
    int64_t n = 0;
    for (const JtItem& it : m->queue) {
        if (n >= K) break;
        m->rows_for(it, rows + n * m->W, true);
        slots[n] = m->binds[static_cast<size_t>(it.b)].slot;
        binds_out[n] = it.b;
        ++n;
    }
    return n;
}

// out[0] = settled returns, out[1] = queued (unsettled) returns,
// out[2] = live invocations, out[3] = current W, out[4] = 1 iff the
// queue FRONT is settleable (advance would walk at least one return —
// settleability is front-blocking, so callers can skip the R
// pack/unpack round trip when this is 0).
int64_t jt_mon_stats(void* h, int64_t* out) {
    auto* m = static_cast<JtMonitor*>(h);
    out[0] = m->settled;
    out[1] = static_cast<int64_t>(m->queue.size());
    out[2] = static_cast<int64_t>(m->live.size());
    out[3] = m->W;
    out[4] = 0;
    if (!m->queue.empty()) {
        std::vector<int32_t> one(static_cast<size_t>(m->W));
        out[4] = m->rows_for(m->queue.front(), one.data(), false) ? 1 : 0;
    }
    return 0;
}

// Live (still-pending) bindings: fills procs/binds up to cap; returns
// the count (the run-over path resolves these as crashed).
int64_t jt_mon_live(void* h, int64_t cap, int64_t* procs,
                    int32_t* binds_out) {
    auto* m = static_cast<JtMonitor*>(h);
    int64_t n = 0;
    for (const auto& kv : m->live) {
        if (n >= cap) break;
        procs[n] = kv.first;
        binds_out[n] = kv.second;
        ++n;
    }
    return n;
}

}  // extern "C"
