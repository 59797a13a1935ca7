// Native graph-construction kernels for the host mesh builder.
//
// The Python/scipy formulation of the node adjacency (incidence-matrix
// triple product, models/annulus.py:node_adjacency) performs ~100M
// duplicate-summing multiply-adds; this direct union build does the same
// job in ~2 orders of magnitude less work.  Exposed via ctypes (see
// native/__init__.py); the scipy product stays as the route of a host
// without g++ and as the twin the tests hold this build to.
//
// Two structural optimisations over a naive per-node union merge:
//   * nodes with an IDENTICAL element list (every secondary node in the
//     interior of the same edge, for instance) have identical adjacency
//     rows - rows are computed once per signature group and shared
//     (~10-20x fewer sort+unique unions on production annulus meshes);
//   * the two-phase ctypes protocol (count pass, then fill pass) caches
//     the phase-1 group rows in thread-local state, so the fill pass is
//     a straight per-node copy instead of a full recompute.
//
// Built at first use by native/__init__.py with
//   g++ -O3 -march=native -shared -fPIC graphbuild.cpp
// into the package's _build/, the library named by a hash of this source,
// the flags and the host CPU.  A copy of the JAX package's
// native/graphbuild.cpp; it includes no PyTorch header.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct GroupCache {
    std::vector<std::vector<int64_t>> rows;  // per group: sorted nodes, self included
    std::vector<int64_t> node_group;         // node -> group id
    std::vector<int64_t> indptr;             // nnods + 1
    bool ready = false;
};

thread_local GroupCache g_cache;

void compute_groups(
    const int64_t* e2n_flat, const int64_t* e2n_off,
    const int64_t* nbr_flat, const int64_t* nbr_off,
    int64_t nel, int64_t nnods, int64_t star, GroupCache& out)
{
    // invert e2n: node -> elements (counting sort; element-ascending per node)
    std::vector<int64_t> eoff(nnods + 1, 0);
    for (int64_t e = 0; e < nel; ++e)
        for (int64_t k = e2n_off[e]; k < e2n_off[e + 1]; ++k)
            ++eoff[e2n_flat[k] + 1];
    for (int64_t n = 0; n < nnods; ++n) eoff[n + 1] += eoff[n];
    std::vector<int64_t> n2e(eoff[nnods]);
    {
        std::vector<int64_t> cur(eoff.begin(), eoff.end() - 1);
        for (int64_t e = 0; e < nel; ++e)
            for (int64_t k = e2n_off[e]; k < e2n_off[e + 1]; ++k)
                n2e[cur[e2n_flat[k]]++] = e;
    }

    // per-element patch: sorted unique nodes of every element within
    // `star` hops of e in the element-neighbour graph (BFS with a stamp
    // array; star=0 -> just e, star=1 -> e + its neighbours, ...)
    std::vector<int64_t> patch_off(nel + 1, 0);
    std::vector<int64_t> patch_flat;
    {
        std::vector<int64_t> tmp;
        std::vector<int64_t> stamp(nel, -1);
        std::vector<int64_t> frontier, next, members;
        patch_flat.reserve(e2n_off[nel] * (star ? 6 : 1));
        for (int64_t e = 0; e < nel; ++e) {
            members.clear();
            members.push_back(e);
            stamp[e] = e;
            frontier.assign(1, e);
            for (int64_t depth = 0; depth < star; ++depth) {
                next.clear();
                for (int64_t f : frontier) {
                    for (int64_t k = nbr_off[f]; k < nbr_off[f + 1]; ++k) {
                        int64_t ne = nbr_flat[k];
                        if (stamp[ne] != e) {
                            stamp[ne] = e;
                            members.push_back(ne);
                            next.push_back(ne);
                        }
                    }
                }
                frontier.swap(next);
            }
            tmp.clear();
            for (int64_t m : members)
                tmp.insert(tmp.end(), e2n_flat + e2n_off[m], e2n_flat + e2n_off[m + 1]);
            std::sort(tmp.begin(), tmp.end());
            tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
            patch_flat.insert(patch_flat.end(), tmp.begin(), tmp.end());
            patch_off[e + 1] = (int64_t)patch_flat.size();
        }
    }

    // group nodes by identical element list (FNV hash + exact compare);
    // union the patches once per group
    out.rows.clear();
    out.node_group.assign(nnods, -1);
    out.indptr.assign(nnods + 1, 0);
    std::unordered_map<uint64_t, std::vector<int64_t>> buckets;
    std::vector<std::pair<int64_t, int64_t>> group_span;  // (start, len) in n2e
    std::vector<int64_t> row;
    buckets.reserve(nnods / 4);

    for (int64_t n = 0; n < nnods; ++n) {
        const int64_t s = eoff[n], len = eoff[n + 1] - s;
        uint64_t h = 1469598103934665603ull;
        for (int64_t k = s; k < s + len; ++k) {
            h ^= (uint64_t)n2e[k];
            h *= 1099511628211ull;
        }
        h ^= (uint64_t)len;
        int64_t gid = -1;
        auto& cand = buckets[h];
        for (int64_t g : cand) {
            if (group_span[g].second == len &&
                std::memcmp(n2e.data() + group_span[g].first, n2e.data() + s,
                            (size_t)len * sizeof(int64_t)) == 0) {
                gid = g;
                break;
            }
        }
        if (gid < 0) {
            row.clear();
            for (int64_t k = s; k < s + len; ++k) {
                int64_t e = n2e[k];
                row.insert(row.end(), patch_flat.begin() + patch_off[e],
                           patch_flat.begin() + patch_off[e + 1]);
            }
            std::sort(row.begin(), row.end());
            row.erase(std::unique(row.begin(), row.end()), row.end());
            gid = (int64_t)out.rows.size();
            out.rows.emplace_back(row);
            group_span.emplace_back(s, len);
            cand.push_back(gid);
        }
        out.node_group[n] = gid;
        // every node appears in its own patch union, so the emitted row
        // (self removed) has size - 1 entries
        out.indptr[n + 1] = out.indptr[n] +
            (int64_t)out.rows[gid].size() - (len ? 1 : 0);
    }
    out.ready = true;
}

}  // namespace

extern "C" {

// Node adjacency of the element-incidence relaxation graph.
//
// Inputs (all int64):
//   e2n_flat / e2n_off   : ragged element -> node lists (nel+1 offsets)
//   nbr_flat / nbr_off   : ragged element -> neighbour-element lists
//   nel, nnods           : counts
//   star                 : 0 = own elements only, s >= 1 = + all elements
//                          within s hops of the element-neighbour graph
//                          (matching the scipy reference's boolean
//                          (I + N)^s expansion, add_star_levels! analogue)
// Two-phase API to let the caller allocate exact output buffers:
//   phase 1 (indices == nullptr): fills indptr (size nnods+1), returns nnz
//   phase 2 (indices != nullptr): fills indices (sorted per row) from the
//   cached phase-1 groups, then frees the cache
int64_t node_adjacency(
    const int64_t* e2n_flat, const int64_t* e2n_off,
    const int64_t* nbr_flat, const int64_t* nbr_off,
    int64_t nel, int64_t nnods, int64_t star,
    int64_t* indptr, int64_t* indices)
{
    // phase 1 always recomputes (a later phase-1 call invalidates any
    // cached result); phase 2 reuses the cache from the immediately
    // preceding phase 1, recomputing only if called standalone
    if (!indices || !g_cache.ready)
        compute_groups(e2n_flat, e2n_off, nbr_flat, nbr_off,
                       nel, nnods, star, g_cache);
    std::memcpy(indptr, g_cache.indptr.data(),
                (size_t)(nnods + 1) * sizeof(int64_t));
    const int64_t nnz = g_cache.indptr[nnods];
    if (!indices) return nnz;

    for (int64_t n = 0; n < nnods; ++n) {
        const auto& row = g_cache.rows[g_cache.node_group[n]];
        int64_t* dst = indices + g_cache.indptr[n];
        const int64_t want = g_cache.indptr[n + 1] - g_cache.indptr[n];
        if ((int64_t)row.size() == want) {  // isolated node edge case
            std::memcpy(dst, row.data(), (size_t)want * sizeof(int64_t));
            continue;
        }
        auto it = std::lower_bound(row.begin(), row.end(), n);
        const size_t before = (size_t)(it - row.begin());
        std::memcpy(dst, row.data(), before * sizeof(int64_t));
        std::memcpy(dst + before, row.data() + before + 1,
                    (row.size() - before - 1) * sizeof(int64_t));
    }
    g_cache = GroupCache();  // free
    return nnz;
}

// Same fill pass emitting int32 indices (scipy's canonical index dtype)
// - saves the caller a full 8-byte->4-byte conversion copy of the nnz
// array.  Call after a phase-1 node_adjacency count call.
int64_t node_adjacency_fill32(
    const int64_t* e2n_flat, const int64_t* e2n_off,
    const int64_t* nbr_flat, const int64_t* nbr_off,
    int64_t nel, int64_t nnods, int64_t star,
    int64_t* indptr, int32_t* indices)
{
    if (!g_cache.ready)
        compute_groups(e2n_flat, e2n_off, nbr_flat, nbr_off,
                       nel, nnods, star, g_cache);
    std::memcpy(indptr, g_cache.indptr.data(),
                (size_t)(nnods + 1) * sizeof(int64_t));
    const int64_t nnz = g_cache.indptr[nnods];
    for (int64_t n = 0; n < nnods; ++n) {
        const auto& row = g_cache.rows[g_cache.node_group[n]];
        int32_t* dst = indices + g_cache.indptr[n];
        const int64_t want = g_cache.indptr[n + 1] - g_cache.indptr[n];
        if ((int64_t)row.size() == want) {
            for (int64_t v : row) *dst++ = (int32_t)v;
            continue;
        }
        for (int64_t v : row)
            if (v != n) *dst++ = (int32_t)v;
    }
    g_cache = GroupCache();  // free
    return nnz;
}

}  // extern "C"
