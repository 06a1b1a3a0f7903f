// Native Wing-Gong-Lowe linearizability search.
//
// Role of upstream knossos/src/knossos/wgl.clj + wgl/dll_history.clj
// (SURVEY.md §2.2): depth-first search over linearization orders with
// Lowe's memoization of <linearized-set, model-state> configurations.
// Independent implementation, C++ instead of Clojure/JVM:
//
// - a mutable doubly-linked list over unlinearized ops gives O(1)
//   lift/unlift during backtracking (upstream dll_history);
// - the memo set stores EXACT normalized keys (state, frontier pointer p,
//   mask words from p upward) — no fingerprint hashing, so no
//   probabilistic false-valid verdicts;
// - model semantics enter only through the dense transition table
//   precomputed by jepsen_tpu.models.memo (upstream model.memo): the
//   search never steps a model object;
// - crashed-op quotient (absent upstream — the "info ops are expensive"
//   2^k blowup): whenever the search fires a crashed (never-returning)
//   op, it fires the LOWEST unfired crashed entry with the same op id
//   instead. The lower twin is legal whenever the higher one is (its
//   invoke is earlier, so the Wing-Gong bound inv[j] < m is weaker) and
//   steps to the same state, and an exchange argument shows restricting
//   to lowest-first firings preserves completeness. Reachable masks are
//   therefore canonical by construction, so the memo collapses the
//   whole 2^k interchangeable class to its k+1 canonical members with
//   no key rewriting.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <chrono>
#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

using u64 = std::uint64_t;
using i64 = std::int64_t;
using i32 = std::int32_t;

constexpr i64 INF = i64(1) << 60;

struct KeyHash {
    std::size_t operator()(const std::vector<u64>& v) const noexcept {
        u64 h = 1469598103934665603ull;            // FNV-1a
        for (u64 w : v) {
            h ^= w;
            h *= 1099511628211ull;
        }
        return static_cast<std::size_t>(h);
    }
};

struct Wgl {
    const i32* table;                              // [S, O] row-major
    i32 O = 0, n = 0;
    const i32* op_id = nullptr;
    std::vector<i64> inv, ret;
    std::vector<u64> mask;                         // linearized bitset
    std::vector<i32> nxt, prv;                     // dll; index n = head
    std::vector<u64> key_buf;
    std::unordered_set<std::vector<u64>, KeyHash> seen;
    // crashed-op quotient: entries sharing (crashed, op id), in entry
    // (= invocation) order; group_of[i] indexes groups, -1 = ungrouped
    std::vector<std::vector<i32>> groups;
    std::vector<i32> group_of;
    i64 explored = 0;
    i32 remaining_ok = 0;
    i32 total_ok = 0;
    i32 best_cover = -1;
    i32 best_stuck = -1;

    i32 step(i32 sid, i32 oid) const {
        return table[static_cast<i64>(sid) * O + oid];
    }

    void lift(i32 i) {                             // linearize i
        mask[i >> 6] |= u64(1) << (i & 63);
        nxt[prv[i]] = nxt[i];
        prv[nxt[i]] = prv[i];
    }

    void unlift(i32 i) {                           // backtrack
        mask[i >> 6] &= ~(u64(1) << (i & 63));
        nxt[prv[i]] = i;
        prv[nxt[i]] = i;
    }

    bool fired(i32 i) const {
        return (mask[i >> 6] >> (i & 63)) & 1;
    }

    // canonical member of a crashed pick's interchangeability class:
    // the lowest unfired twin (see header comment)
    i32 canonical_pick(i32 pick) const {
        i32 g = group_of[pick];
        if (g < 0) return pick;
        for (i32 m : groups[g])
            if (!fired(m)) return m;
        return pick;                               // unreachable: pick unfired
    }

    // Normalized memo key: every entry below p (the lowest unlinearized
    // one) is linearized in any config sharing p, so the key needs only
    // the words from p's word upward, trimmed of trailing zeros. Exact:
    // the full mask is reconstructible from (p, window).
    bool memo_insert(i32 sid, i32 p) {
        key_buf.clear();
        key_buf.push_back((static_cast<u64>(static_cast<std::uint32_t>(sid))
                           << 32) |
                          static_cast<u64>(static_cast<std::uint32_t>(p)));
        i32 wp = (p >= n ? n : p) >> 6;
        i32 wlast = static_cast<i32>(mask.size()) - 1;
        while (wlast > wp && mask[wlast] == 0) --wlast;
        for (i32 w = wp; w <= wlast; ++w) key_buf.push_back(mask[w]);
        return seen.insert(key_buf).second;
    }
};

}  // namespace

extern "C" {

// out[0] verdict: 1 valid, 0 invalid, -1 unknown
// out[1] stuck entry index (for invalid verdicts)
// out[2] max ok-ops linearized in any fully-explored config
// out[3] cause: 0 none, 1 timeout, 2 config-explosion, 3 aborted
//
// Failure evidence (knossos :final-paths analogue): with cfg_cap > 0,
// up to cfg_cap dead-end configurations at the DEEPEST cover are
// emitted as (cfg_sid[i], cfg_mask[i * mask_words .. +mask_words))
// where mask_words = (n + 63)/64 + 1 — the caller reconstructs model
// state and linearized-pending ops from the mask. *n_cfg receives the
// count. Collection resets whenever a deeper cover is reached, so the
// survivors are exactly the configurations the search was stuck at.
//
// returns configs explored
i64 wgl_check(const i32* table, i32 S, i32 O,
              const i32* inv_ev, const i64* ret_ev, const i32* op_id,
              const std::uint8_t* crashed, i32 n,
              i64 max_configs, double time_limit_s,
              const volatile i32* abort_flag, i32* out,
              i32 cfg_cap, i32* cfg_sid, u64* cfg_mask, i32* n_cfg) {
    (void)S;
    Wgl w;
    w.table = table;
    w.O = O;
    w.n = n;
    w.op_id = op_id;
    w.inv.resize(n);
    w.ret.resize(n);
    w.mask.assign(static_cast<std::size_t>(n + 63) / 64 + 1, 0);
    w.nxt.resize(n + 1);
    w.prv.resize(n + 1);
    for (i32 i = 0; i < n; ++i) {
        w.inv[i] = inv_ev[i];
        w.ret[i] = crashed[i] ? INF : ret_ev[i];
        if (!crashed[i]) ++w.total_ok;
        w.nxt[i] = i + 1;
        w.prv[i + 1] = i;
    }
    w.nxt[n] = 0;                                  // head sentinel
    w.prv[0] = n;
    w.remaining_ok = w.total_ok;
    w.group_of.assign(n, -1);
    {
        std::unordered_map<i32, i32> gid;          // op id -> group index
        for (i32 i = 0; i < n; ++i) {
            if (!crashed[i]) continue;
            auto it = gid.find(op_id[i]);
            if (it == gid.end()) {
                it = gid.emplace(op_id[i],
                                 static_cast<i32>(w.groups.size())).first;
                w.groups.emplace_back();
            }
            w.groups[it->second].push_back(i);     // ascending entry order
            w.group_of[i] = it->second;
        }
        for (i32 i = 0; i < n; ++i)                // singletons: no redirect
            if (w.group_of[i] >= 0 && w.groups[w.group_of[i]].size() < 2)
                w.group_of[i] = -1;
    }
    out[0] = 1;
    out[1] = -1;
    out[2] = 0;
    out[3] = 0;
    if (n_cfg) *n_cfg = 0;
    if (w.total_ok == 0) return 0;

    auto t0 = std::chrono::steady_clock::now();
    i32 cause = 0;
    auto over_budget = [&]() -> bool {
        if (abort_flag && *abort_flag) { cause = 3; return true; }
        if (time_limit_s > 0) {
            double el = std::chrono::duration<double>(
                std::chrono::steady_clock::now() - t0).count();
            if (el > time_limit_s) { cause = 1; return true; }
        }
        if (static_cast<i64>(w.seen.size()) > max_configs) {
            cause = 2;
            return true;
        }
        return false;
    };

    // Iterative DFS with undo. A frame's `chosen` is the entry that was
    // linearized to ENTER it (undone when the frame pops); `cursor`/`m`
    // hold its candidate scan: next dll entry to try, and the min return
    // time over entries already scanned (the Wing-Gong legality bound:
    // a candidate j is legal only while inv[j] < m).
    struct Frame {
        i32 sid;
        i32 chosen;
        i32 cursor;
        i64 m;
        i32 cover;
    };
    std::vector<Frame> stack;
    stack.push_back({0, -1, w.nxt[n], INF, 0});
    w.memo_insert(0, w.nxt[n]);
    i64 tick = 0;

    while (!stack.empty()) {
        Frame& f = stack.back();
        if ((tick++ & 255) == 0 && over_budget()) {
            out[0] = -1;
            out[3] = cause;
            return w.explored;
        }
        i32 j = f.cursor;
        i32 pick = -1, pick_sid = -1;
        while (j < n) {
            if (w.inv[j] >= f.m) break;
            i32 sid2 = w.step(f.sid, w.op_id[j]);
            i64 rj = w.ret[j];
            i32 jn = w.nxt[j];
            if (rj < f.m) f.m = rj;
            if (sid2 >= 0) {
                pick = j;
                pick_sid = sid2;
                f.cursor = jn;
                break;
            }
            j = jn;
        }
        if (pick < 0) {
            if (f.cover > w.best_cover) {
                w.best_cover = f.cover;
                i32 s = w.nxt[n];                  // lowest unlinearized ok
                while (s < n && w.ret[s] == INF) s = w.nxt[s];
                w.best_stuck = (s < n) ? s : w.nxt[n];
                if (n_cfg) *n_cfg = 0;             // deeper: restart evidence
            }
            if (cfg_cap > 0 && n_cfg && f.cover == w.best_cover
                && *n_cfg < cfg_cap) {
                const i64 words = static_cast<i64>(w.mask.size());
                cfg_sid[*n_cfg] = f.sid;
                for (i64 wd = 0; wd < words; ++wd)
                    cfg_mask[static_cast<i64>(*n_cfg) * words + wd] =
                        w.mask[static_cast<std::size_t>(wd)];
                ++*n_cfg;
            }
            i32 ch = f.chosen;
            stack.pop_back();
            if (ch >= 0) {
                w.unlift(ch);
                if (w.ret[ch] != INF) ++w.remaining_ok;
            }
            continue;
        }
        ++w.explored;
        if (w.ret[pick] == INF) pick = w.canonical_pick(pick);
        w.lift(pick);
        bool is_ok = (w.ret[pick] != INF);
        if (is_ok && --w.remaining_ok == 0) {
            out[0] = 1;
            out[2] = w.total_ok;
            return w.explored;
        }
        i32 child_cover = f.cover + (is_ok ? 1 : 0);
        i32 p = w.nxt[n];
        if (w.memo_insert(pick_sid, p)) {
            stack.push_back({pick_sid, pick, p, INF, child_cover});
        } else {
            w.unlift(pick);
            if (is_ok) ++w.remaining_ok;
        }
    }

    out[0] = 0;
    out[1] = (w.best_stuck >= 0) ? w.best_stuck : w.nxt[n];
    out[2] = (w.best_cover >= 0) ? w.best_cover : 0;
    return w.explored;
}

}  // extern "C"
