// Native lease-store engine: the host-runtime hot path in C++.
//
// Capability parity with the Python LeaseStore
// (doorman_tpu/core/store.py, itself mirroring reference
// reference go/server/doorman/store.go:68-213): per-resource
// client -> lease maps with O(1) running sum_has / sum_wants / subclient
// aggregates, expiry sweep, and a bulk resource-major edge dump feeding
// the batch solver's snapshot packer without per-lease Python overhead.
//
// One Engine holds every resource of a server, so a tick's snapshot is a
// single dm_pack call. String ids are interned once at the boundary
// (dm_resource / dm_client); all per-request operations afterwards are
// integer-keyed. The clock is injected from the caller (absolute expiry
// stamps, `now` for sweeps) so simulated time works identically to the
// Python store.
//
// Iteration/packing order is deterministic: insertion order, perturbed
// only by swap-remove on release/expiry — the same guarantee the Python
// store documents for reproducible packing.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Lease {
  double expiry;
  double refresh_interval;
  double has;
  double wants;
  int32_t subclients;
  int64_t priority;
};

struct ResourceStore {
  std::unordered_map<int64_t, size_t> index;  // client handle -> slot
  std::vector<int64_t> clients;               // slot -> client handle
  std::vector<Lease> leases;                  // slot -> lease
  double sum_has = 0.0;
  double sum_wants = 0.0;
  int64_t count = 0;  // total subclients
  // Membership epoch: bumped whenever the client->slot mapping changes
  // (insert, release, expiry sweep). The device-resident solver records
  // the epoch it uploaded and skips write-backs whose rows went stale
  // while the solve was in flight.
  uint64_t version = 0;
  // Set when the row changed beyond wants (membership, has, subclients,
  // priority) since the last drain2: such rows need a full re-upload,
  // while wants-only churn — the steady-state refresh traffic — ships
  // just the wants lane over the (slow) host<->device link.
  uint8_t dirty_full = 0;
  // Lower bound on every lease's expiry: the per-tick engine-wide sweep
  // skips the whole resource while now <= min_expiry, turning the O(all
  // leases) scan into O(resources) in steady state. Writes only tighten
  // it (removals and later re-stamps leave it loose); a sweep that does
  // scan recomputes it exactly from the survivors.
  double min_expiry = std::numeric_limits<double>::infinity();

  // Wide-resource (chunked) tracking: a resource wider than the dense
  // bucket cap is split across consecutive device rows of
  // engine.chunk_width slots each. Dirtiness is per SLOT (a single
  // client's wants change must not re-upload a million-lease table),
  // write-back validity per CHUNK (chunk_version bumps whenever the
  // slot<->client mapping inside that chunk changes, so an in-flight
  // apply skips exactly the chunks whose slot order went stale).
  bool chunk_tracked = false;
  std::vector<uint64_t> chunk_version;
  std::vector<uint8_t> slot_dirty;        // 0 clean, 1 wants-only, 2 full
  std::vector<int64_t> slot_dirty_list;
};

struct Engine {
  std::vector<ResourceStore> resources;
  std::unordered_map<std::string, int32_t> resource_ids;
  std::unordered_map<std::string, int64_t> client_ids;
  int64_t next_client = 0;
  // Dirty tracking for delta uploads: a resource is dirty when any
  // solver-visible input changed (wants/has/subclients/priority or
  // membership) since the last drain. Pure expiry refreshes with
  // unchanged demand do NOT dirty a row — the steady-state refresh
  // storm must not defeat delta uploads.
  std::vector<uint8_t> dirty_flags;
  std::vector<int32_t> dirty_list;
  // Chunk width for wide-resource tracking (0 = disabled). Resources
  // opted in via dm_chunk_config get slot-granular dirty lists and
  // per-chunk membership versions on top of the per-resource flags
  // above; the two channels are independent, so the narrow resident
  // solver's drains never consume (or get consumed by) the wide
  // solver's.
  int64_t chunk_width = 0;
  std::vector<int32_t> slot_dirty_rids;  // tracked rids with dirty slots
  // One writer (tick thread) and many RPC-handler calls share the
  // engine once the server moves prepare/apply off the event loop;
  // every exported call locks. ctypes releases the GIL during calls,
  // so a long pack blocks only callers touching this engine.
  std::mutex mu;
};

// Mark one slot of a chunk-tracked resource dirty (level 1 = wants-only,
// 2 = full: has/subclients/priority or slot content changed). Levels
// only upgrade until the next drain.
inline void mark_slot(Engine *e, int32_t rid, ResourceStore &r, size_t slot,
                      uint8_t level) {
  if (!r.chunk_tracked || e->chunk_width <= 0) return;
  if (r.slot_dirty.size() <= slot) r.slot_dirty.resize(slot + 1, 0);
  if (!r.slot_dirty[slot]) {
    if (r.slot_dirty_list.empty()) e->slot_dirty_rids.push_back(rid);
    r.slot_dirty_list.push_back(static_cast<int64_t>(slot));
  }
  if (level > r.slot_dirty[slot]) r.slot_dirty[slot] = level;
}

// The slot<->client mapping inside `slot`'s chunk changed (insert,
// swap-remove): an in-flight dense apply of that chunk would write
// grants against the wrong clients, so its version moves.
inline void bump_chunk(Engine *e, ResourceStore &r, size_t slot) {
  if (!r.chunk_tracked || e->chunk_width <= 0) return;
  const size_t c = slot / static_cast<size_t>(e->chunk_width);
  if (r.chunk_version.size() <= c) r.chunk_version.resize(c + 1, 0);
  ++r.chunk_version[c];
}

// Swap-remove `slot`, maintaining aggregates, the membership epoch, and
// — for chunk-tracked resources — the chunk versions and slot dirt of
// both touched chunks (the removed slot and the moved-from last slot).
inline void remove_slot(Engine *e, int32_t rid, ResourceStore &r,
                        size_t slot) {
  const Lease &l = r.leases[slot];
  r.sum_has -= l.has;
  r.sum_wants -= l.wants;
  r.count -= l.subclients;
  r.index.erase(r.clients[slot]);
  const size_t last = r.clients.size() - 1;
  if (slot != last) {
    r.clients[slot] = r.clients[last];
    r.leases[slot] = r.leases[last];
    r.index[r.clients[slot]] = slot;
    mark_slot(e, rid, r, slot, 2);
  }
  r.clients.pop_back();
  r.leases.pop_back();
  ++r.version;
  r.dirty_full = 1;
  bump_chunk(e, r, slot);
  bump_chunk(e, r, last);
  // The vacated last slot goes inactive on device; ship its (zeroed)
  // state so a stale lease doesn't keep solving there.
  mark_slot(e, rid, r, last, 2);
}

// Shared expiry sweep: skipped entirely while nothing can be expired
// (the min_expiry lower bound), else swap-removes lapsed leases and
// recomputes the exact bound from the survivors.
inline int64_t sweep_resource(Engine *e, int32_t rid, ResourceStore &r,
                              double now) {
  if (!(now > r.min_expiry)) return 0;
  int64_t removed = 0;
  double new_min = std::numeric_limits<double>::infinity();
  for (size_t slot = 0; slot < r.leases.size();) {
    if (now > r.leases[slot].expiry) {
      remove_slot(e, rid, r, slot);  // swap-remove: re-check the slot
      ++removed;
    } else {
      if (r.leases[slot].expiry < new_min) new_min = r.leases[slot].expiry;
      ++slot;
    }
  }
  r.min_expiry = new_min;
  return removed;
}

// API convention: every extern entry point treats an out-of-range
// resource handle as a no-op (skip / return 0 / zero-fill) — a
// Python-level bookkeeping bug must degrade to a miss at this ctypes
// boundary, never to an out-of-bounds access.
inline bool valid_rid(const Engine *e, int32_t rid) {
  return rid >= 0 && rid < static_cast<int32_t>(e->resources.size());
}

inline void mark_dirty(Engine *e, int32_t rid) {
  if (e->dirty_flags.size() < e->resources.size())
    e->dirty_flags.resize(e->resources.size(), 0);
  if (!e->dirty_flags[rid]) {
    e->dirty_flags[rid] = 1;
    e->dirty_list.push_back(rid);
  }
}

// Shared upsert body (dm_assign and dm_bulk_assign): insert or replace
// the client's lease, maintaining the running aggregates by delta.
// Returns 1 if the client already held a lease, 0 if new.
inline int32_t upsert(Engine *e, int32_t rid, int64_t cid,
                      const Lease &fresh) {
  ResourceStore &r = e->resources[rid];
  auto it = r.index.find(cid);
  if (it == r.index.end()) {
    const size_t slot = r.clients.size();
    r.index.emplace(cid, slot);
    r.clients.push_back(cid);
    r.leases.push_back(fresh);
    r.sum_has += fresh.has;
    r.sum_wants += fresh.wants;
    r.count += fresh.subclients;
    ++r.version;
    r.dirty_full = 1;
    mark_dirty(e, rid);
    bump_chunk(e, r, slot);
    mark_slot(e, rid, r, slot, 2);
    if (fresh.expiry < r.min_expiry) r.min_expiry = fresh.expiry;
    return 0;
  }
  Lease &l = r.leases[it->second];
  const bool full_changed = l.has != fresh.has ||
                            l.subclients != fresh.subclients ||
                            l.priority != fresh.priority;
  if (full_changed) r.dirty_full = 1;
  if (full_changed || l.wants != fresh.wants) {
    mark_dirty(e, rid);
    mark_slot(e, rid, r, it->second, full_changed ? 2 : 1);
  }
  r.sum_has += fresh.has - l.has;
  r.sum_wants += fresh.wants - l.wants;
  r.count += fresh.subclients - l.subclients;
  l = fresh;
  if (fresh.expiry < r.min_expiry) r.min_expiry = fresh.expiry;
  return 1;
}

}  // namespace

extern "C" {

Engine *dm_engine_new() { return new Engine(); }

void dm_engine_free(Engine *e) { delete e; }

// Get-or-create the resource store for `id`; returns its handle.
int32_t dm_resource(Engine *e, const char *id) {
  std::lock_guard<std::mutex> lock(e->mu);
  auto it = e->resource_ids.find(id);
  if (it != e->resource_ids.end()) return it->second;
  const int32_t rid = static_cast<int32_t>(e->resources.size());
  e->resource_ids.emplace(id, rid);
  e->resources.emplace_back();
  e->dirty_flags.push_back(0);
  return rid;
}

// Intern a client id; returns its handle (stable for the engine's life).
int64_t dm_client(Engine *e, const char *id) {
  std::lock_guard<std::mutex> lock(e->mu);
  auto it = e->client_ids.find(id);
  if (it != e->client_ids.end()) return it->second;
  const int64_t cid = e->next_client++;
  e->client_ids.emplace(id, cid);
  return cid;
}

// Upsert a lease; running sums update by delta. Returns 1 if the client
// already held a lease, 0 if this is a new entry.
int32_t dm_assign(Engine *e, int32_t rid, int64_t cid, double expiry,
                  double refresh_interval, double has, double wants,
                  int32_t subclients, int64_t priority) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  return upsert(e, rid, cid,
                Lease{expiry, refresh_interval, has, wants, subclients,
                      priority});
}

// Bulk upsert: one call assigns n leases (snapshot load / state
// transfer; the per-call ctypes overhead of dm_assign dominates it for
// large n). rid[i] are engine resource handles per edge; out-of-range
// handles are skipped. Returns the number assigned.
int64_t dm_bulk_assign(Engine *e, const int32_t *rid, const int64_t *cid,
                       const double *expiry, const double *refresh,
                       const double *has, const double *wants,
                       const int32_t *subclients, const int64_t *priority,
                       int64_t n) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t assigned = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid_rid(e, rid[i])) continue;
    upsert(e, rid[i], cid[i],
           Lease{expiry[i], refresh[i], has[i], wants[i], subclients[i],
                 priority[i]});
    ++assigned;
  }
  return assigned;
}

// Update ONLY the granted capacity of an existing lease — the
// single-lease form of the apply write-back (same semantics: no expiry
// or refresh change, and NO dirty marking: a grant delivery is the
// solver writing its own output, not new demand; marking it dirty
// would force a full re-upload next tick and defeat the idle fast
// path). Returns 1 if the client held a lease, else 0.
int32_t dm_regrant(Engine *e, int32_t rid, int64_t cid, double has) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  ResourceStore &r = e->resources[rid];
  auto it = r.index.find(cid);
  if (it == r.index.end()) return 0;
  Lease &l = r.leases[it->second];
  r.sum_has += has - l.has;
  l.has = has;
  return 1;
}

// Returns 1 if the client held a lease (now removed), else 0.
int32_t dm_release(Engine *e, int32_t rid, int64_t cid) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  ResourceStore &r = e->resources[rid];
  auto it = r.index.find(cid);
  if (it == r.index.end()) return 0;
  remove_slot(e, rid, r, it->second);
  mark_dirty(e, rid);
  return 1;
}

// Sweep leases with expiry < now (strict: `now > expiry` like the Python
// store); returns how many were removed.
int64_t dm_clean(Engine *e, int32_t rid, double now) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  ResourceStore &r = e->resources[rid];
  const int64_t removed = sweep_resource(e, rid, r, now);
  if (removed) mark_dirty(e, rid);
  return removed;
}

// Engine-wide expiry sweep in one call; returns total removed.
int64_t dm_clean_all(Engine *e, double now) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t removed = 0;
  for (size_t rid = 0; rid < e->resources.size(); ++rid) {
    ResourceStore &r = e->resources[rid];
    const int64_t here =
        sweep_resource(e, static_cast<int32_t>(rid), r, now);
    if (here) mark_dirty(e, static_cast<int32_t>(rid));
    removed += here;
  }
  return removed;
}

// Drain the dirty-resource list: writes up to `cap` dirty handles to
// `out`, clears the flags (incl. dirty_full, reported in full_out:
// full_out[i]=1 means the row changed beyond wants since its last
// drain and needs a full re-upload), returns the count written.
int64_t dm_drain_dirty2(Engine *e, int32_t *out, uint8_t *full_out,
                        int64_t cap) {
  std::lock_guard<std::mutex> lock(e->mu);
  const int64_t n =
      std::min<int64_t>(cap, static_cast<int64_t>(e->dirty_list.size()));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t rid = e->dirty_list[i];
    out[i] = rid;
    e->dirty_flags[rid] = 0;
    full_out[i] = e->resources[rid].dirty_full;
    e->resources[rid].dirty_full = 0;
  }
  e->dirty_list.erase(e->dirty_list.begin(), e->dirty_list.begin() + n);
  return n;
}

// Dense row pack: for each of n resources, write its leases into row i
// of the [n, K] slabs (slot-major, zero padding beyond the count).
// counts_out[i] is the resource's FULL lease count (callers detect
// K overflow when counts_out[i] > K); versions_out[i] its membership
// epoch at pack time.
void dm_pack_rows(Engine *e, const int32_t *rids, int64_t n, int64_t K,
                  double *wants, double *has, double *sub, uint8_t *act,
                  int32_t *counts_out, uint64_t *versions_out) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int64_t i = 0; i < n; ++i) {
    double *w = wants + i * K;
    double *h = has + i * K;
    double *s = sub + i * K;
    uint8_t *a = act + i * K;
    if (!valid_rid(e, rids[i])) {
      std::fill(w, w + K, 0.0);
      std::fill(h, h + K, 0.0);
      std::fill(s, s + K, 0.0);
      std::fill(a, a + K, uint8_t{0});
      counts_out[i] = 0;
      versions_out[i] = 0;
      continue;
    }
    const ResourceStore &r = e->resources[rids[i]];
    const int64_t filled =
        std::min<int64_t>(K, static_cast<int64_t>(r.leases.size()));
    for (int64_t j = 0; j < filled; ++j) {
      const Lease &l = r.leases[j];
      w[j] = l.wants;
      h[j] = l.has;
      s[j] = l.subclients;
      a[j] = 1;
    }
    std::fill(w + filled, w + K, 0.0);
    std::fill(h + filled, h + K, 0.0);
    std::fill(s + filled, s + K, 0.0);
    std::fill(a + filled, a + K, uint8_t{0});
    counts_out[i] = static_cast<int32_t>(r.leases.size());
    versions_out[i] = r.version;
  }
}

// Per-priority-band aggregates of one resource: writes up to `cap`
// distinct (priority, wants-sum, subclient-count) triples in ascending
// priority order; returns the number of bands. Feeds the intermediate
// server's upstream aggregation without per-lease Python objects.
int64_t dm_band_aggregates(Engine *e, int32_t rid, int64_t *prio_out,
                           double *wants_out, int64_t *num_out,
                           int64_t cap) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  const ResourceStore &r = e->resources[rid];
  // O(L) accumulate + O(B log B) sort: this runs under the engine
  // mutex for million-lease stores, so no per-lease band scan.
  std::unordered_map<int64_t, std::pair<double, int64_t>> acc;
  for (const Lease &l : r.leases) {
    auto &slot = acc[l.priority];
    slot.first += l.wants;
    slot.second += l.subclients;
  }
  std::vector<std::pair<int64_t, std::pair<double, int64_t>>> bands(
      acc.begin(), acc.end());
  std::sort(bands.begin(), bands.end());
  const int64_t n = std::min<int64_t>(
      cap, static_cast<int64_t>(bands.size()));
  for (int64_t i = 0; i < n; ++i) {
    prio_out[i] = bands[i].first;
    wants_out[i] = bands[i].second.first;
    num_out[i] = bands[i].second.second;
  }
  return n;
}

// Bulk demand refresh: update wants and stamp expiry/refresh for n
// leases, PRESERVING each lease's current has/subclients/priority —
// the store effect of a client's periodic GetCapacity refresh. Missing
// clients and out-of-range handles are skipped. Returns the number
// refreshed.
int64_t dm_bulk_refresh(Engine *e, const int32_t *rid, const int64_t *cid,
                        const double *expiry, const double *refresh,
                        const double *wants, int64_t n) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t refreshed = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid_rid(e, rid[i])) continue;
    ResourceStore &r = e->resources[rid[i]];
    auto it = r.index.find(cid[i]);
    if (it == r.index.end()) continue;
    Lease &l = r.leases[it->second];
    if (l.wants != wants[i]) {
      mark_dirty(e, rid[i]);
      mark_slot(e, rid[i], r, it->second, 1);
    }
    r.sum_wants += wants[i] - l.wants;
    l.wants = wants[i];
    l.expiry = expiry[i];
    l.refresh_interval = refresh[i];
    if (expiry[i] < r.min_expiry) r.min_expiry = expiry[i];
    ++refreshed;
  }
  return refreshed;
}

// Dense grant write-back: grants is [n, K] row-major in the slot order
// of each resource AT UPLOAD TIME. A row only applies when the
// resource's membership epoch still equals expected_version[i] — rows
// that changed while the solve was in flight are skipped (their change
// dirtied the row, so the next tick re-solves and re-delivers them).
// Writes ONLY the granted capacity: lease expiry/refresh advance when
// the client itself refreshes (the decide path), never on delivery —
// otherwise a crashed client's lease would be renewed forever by the
// tick and its capacity never reclaimed (reference semantics: Decide
// stamps the requester only, store.go:153-181). keep_has[i] != 0
// preserves even has (learning-mode replay). Returns rows applied.
int64_t dm_apply_dense(Engine *e, const int32_t *rids, int64_t n,
                       int64_t K, const double *grants,
                       const uint8_t *keep_has,
                       const uint64_t *expected_version) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t applied = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid_rid(e, rids[i])) continue;
    ResourceStore &r = e->resources[rids[i]];
    if (r.version != expected_version[i]) continue;
    if (!keep_has[i]) {
      const double *g = grants + i * K;
      const int64_t filled =
          std::min<int64_t>(K, static_cast<int64_t>(r.leases.size()));
      for (int64_t j = 0; j < filled; ++j) {
        Lease &l = r.leases[j];
        r.sum_has += g[j] - l.has;
        l.has = g[j];
      }
    }
    ++applied;
  }
  return applied;
}

// ---- Wide-resource (chunked) tracking --------------------------------
//
// A resource wider than the dense bucket cap spans consecutive device
// rows of `W` slots each (slot s lives at row s/W, lane s%W). These
// calls give the wide resident solver slot-granular upload deltas and
// chunk-granular write-back validity, independent of the per-resource
// dirty channel the narrow solver drains.

// Install the tracked set: chunk width W, tracked rids. Clears all
// previous chunk state (slot dirt, chunk versions) engine-wide; the
// caller repacks every tracked chunk right after (a rebuild), so
// versions restart at 0.
void dm_chunk_config(Engine *e, const int32_t *rids, int64_t n,
                     int64_t W) {
  std::lock_guard<std::mutex> lock(e->mu);
  e->chunk_width = W;
  e->slot_dirty_rids.clear();
  for (ResourceStore &r : e->resources) {
    r.chunk_tracked = false;
    r.chunk_version.clear();
    r.slot_dirty.clear();
    r.slot_dirty_list.clear();
  }
  for (int64_t i = 0; i < n; ++i) {
    if (!valid_rid(e, rids[i])) continue;
    ResourceStore &r = e->resources[rids[i]];
    r.chunk_tracked = true;
    const size_t chunks =
        W > 0 ? (r.leases.size() + W - 1) / static_cast<size_t>(W) : 0;
    r.chunk_version.assign(std::max<size_t>(chunks, 1), 0);
  }
}

// Drain one tracked resource's dirty slots: writes up to `cap`
// (slot, level) pairs — level 1 = wants-only, 2 = full — and clears
// them. Returns the count written (call again if == cap).
int64_t dm_drain_slots(Engine *e, int32_t rid, int64_t *slots_out,
                       uint8_t *level_out, int64_t cap) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  ResourceStore &r = e->resources[rid];
  const int64_t n = std::min<int64_t>(
      cap, static_cast<int64_t>(r.slot_dirty_list.size()));
  for (int64_t i = 0; i < n; ++i) {
    const int64_t slot = r.slot_dirty_list[i];
    slots_out[i] = slot;
    level_out[i] =
        slot < static_cast<int64_t>(r.slot_dirty.size())
            ? r.slot_dirty[slot]
            : uint8_t{2};
    if (slot < static_cast<int64_t>(r.slot_dirty.size()))
      r.slot_dirty[slot] = 0;
  }
  r.slot_dirty_list.erase(r.slot_dirty_list.begin(),
                          r.slot_dirty_list.begin() + n);
  if (r.slot_dirty_list.empty()) {
    auto &v = e->slot_dirty_rids;
    v.erase(std::remove(v.begin(), v.end(), rid), v.end());
  }
  return n;
}

// Tracked rids that currently have dirty slots; returns count (<= cap).
int64_t dm_dirty_slot_rids(Engine *e, int32_t *out, int64_t cap) {
  std::lock_guard<std::mutex> lock(e->mu);
  const int64_t n = std::min<int64_t>(
      cap, static_cast<int64_t>(e->slot_dirty_rids.size()));
  for (int64_t i = 0; i < n; ++i) out[i] = e->slot_dirty_rids[i];
  return n;
}

// Gather n slots' solver-visible state (wants/has/subclients/active);
// slots at/beyond the lease count read as inactive zeros (that IS the
// upload that clears a vacated lane on device).
void dm_pack_slots(Engine *e, int32_t rid, const int64_t *slots, int64_t n,
                   double *wants, double *has, double *sub, uint8_t *act) {
  std::lock_guard<std::mutex> lock(e->mu);
  const bool ok = valid_rid(e, rid);
  const ResourceStore *r = ok ? &e->resources[rid] : nullptr;
  const int64_t size =
      ok ? static_cast<int64_t>(r->leases.size()) : 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = slots[i];
    if (s < 0 || s >= size) {
      wants[i] = has[i] = sub[i] = 0.0;
      act[i] = 0;
      continue;
    }
    const Lease &l = r->leases[s];
    wants[i] = l.wants;
    has[i] = l.has;
    sub[i] = l.subclients;
    act[i] = 1;
  }
}

// Pack n chunks as rows of the [n, W] slabs: row i holds slots
// [chunks[i]*W, chunks[i]*W + W) of rids[i] (zeros beyond the lease
// count). filled_out[i] = live slots in the chunk; versions_out[i] =
// the chunk's membership version at pack time.
void dm_pack_chunks(Engine *e, const int32_t *rids, const int32_t *chunks,
                    int64_t n, int64_t W, double *wants, double *has,
                    double *sub, uint8_t *act, int32_t *filled_out,
                    uint64_t *versions_out) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int64_t i = 0; i < n; ++i) {
    double *w = wants + i * W;
    double *h = has + i * W;
    double *s = sub + i * W;
    uint8_t *a = act + i * W;
    std::fill(w, w + W, 0.0);
    std::fill(h, h + W, 0.0);
    std::fill(s, s + W, 0.0);
    std::fill(a, a + W, uint8_t{0});
    filled_out[i] = 0;
    versions_out[i] = 0;
    if (!valid_rid(e, rids[i]) || chunks[i] < 0) continue;
    const ResourceStore &r = e->resources[rids[i]];
    const int64_t base = static_cast<int64_t>(chunks[i]) * W;
    const int64_t size = static_cast<int64_t>(r.leases.size());
    const int64_t filled = std::min<int64_t>(W, size - base);
    for (int64_t j = 0; j < filled; ++j) {
      const Lease &l = r.leases[base + j];
      w[j] = l.wants;
      h[j] = l.has;
      s[j] = l.subclients;
      a[j] = 1;
    }
    if (filled > 0) filled_out[i] = static_cast<int32_t>(filled);
    if (chunks[i] < static_cast<int64_t>(r.chunk_version.size()))
      versions_out[i] = r.chunk_version[chunks[i]];
  }
}

// Read the current membership versions of n chunks. The wide solver
// reads these AFTER draining slot dirt and BEFORE packing: any
// membership change landing after the read bumps the version (so the
// in-flight apply skips) and re-marks its slots (so the next tick
// re-delivers) — expected versions can lag the device state but never
// lead it, which makes a mismatch always the safe direction.
void dm_chunk_versions(Engine *e, const int32_t *rids,
                       const int32_t *chunks, int64_t n,
                       uint64_t *versions_out) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int64_t i = 0; i < n; ++i) {
    versions_out[i] = 0;
    if (!valid_rid(e, rids[i]) || chunks[i] < 0) continue;
    const ResourceStore &r = e->resources[rids[i]];
    if (chunks[i] < static_cast<int64_t>(r.chunk_version.size()))
      versions_out[i] = r.chunk_version[chunks[i]];
  }
}

// Chunk-granular grant write-back: row i of grants [n, W] applies to
// slots [chunks[i]*W, ...) of rids[i] IF the chunk's membership version
// still equals expected_version[i] (a stale chunk re-delivers after its
// change re-dirties it). Grants only — expiry/refresh stay
// client-driven; keep_has[i] != 0 preserves has (learning replay).
// Returns chunks applied.
int64_t dm_apply_chunks(Engine *e, const int32_t *rids,
                        const int32_t *chunks, int64_t n, int64_t W,
                        const double *grants, const uint8_t *keep_has,
                        const uint64_t *expected_version) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t applied = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid_rid(e, rids[i]) || chunks[i] < 0) continue;
    ResourceStore &r = e->resources[rids[i]];
    const uint64_t v =
        chunks[i] < static_cast<int64_t>(r.chunk_version.size())
            ? r.chunk_version[chunks[i]]
            : 0;
    if (v != expected_version[i]) continue;
    if (!keep_has[i]) {
      const double *g = grants + i * W;
      const int64_t base = static_cast<int64_t>(chunks[i]) * W;
      const int64_t filled = std::min<int64_t>(
          W, static_cast<int64_t>(r.leases.size()) - base);
      for (int64_t j = 0; j < filled; ++j) {
        Lease &l = r.leases[base + j];
        r.sum_has += g[j] - l.has;
        l.has = g[j];
      }
    }
    ++applied;
  }
  return applied;
}

// out[0]=sum_has out[1]=sum_wants out[2]=subclient count out[3]=#leases
void dm_sums(Engine *e, int32_t rid, double *out) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) {
    out[0] = out[1] = out[2] = out[3] = 0.0;
    return;
  }
  const ResourceStore &r = e->resources[rid];
  out[0] = r.sum_has;
  out[1] = r.sum_wants;
  out[2] = static_cast<double>(r.count);
  out[3] = static_cast<double>(r.leases.size());
}

// dm_sums for n resources under one lock: out[i*4 .. i*4+3] is
// dm_sums(rids[i]), zeros for an invalid rid. One consistent snapshot
// of every row, in one crossing (the flight record's store digest).
void dm_sums_many(Engine *e, const int32_t *rids, int64_t n, double *out) {
  std::lock_guard<std::mutex> lock(e->mu);
  for (int64_t i = 0; i < n; ++i) {
    double *o = out + 4 * i;
    if (!valid_rid(e, rids[i])) {
      o[0] = o[1] = o[2] = o[3] = 0.0;
      continue;
    }
    const ResourceStore &r = e->resources[rids[i]];
    o[0] = r.sum_has;
    o[1] = r.sum_wants;
    o[2] = static_cast<double>(r.count);
    o[3] = static_cast<double>(r.leases.size());
  }
}

// Fetch one lease: out = {expiry, refresh_interval, has, wants,
// subclients, priority}. Returns 1 if present, else 0 (out untouched).
int32_t dm_get(Engine *e, int32_t rid, int64_t cid, double *out) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  const ResourceStore &r = e->resources[rid];
  auto it = r.index.find(cid);
  if (it == r.index.end()) return 0;
  const Lease &l = r.leases[it->second];
  out[0] = l.expiry;
  out[1] = l.refresh_interval;
  out[2] = l.has;
  out[3] = l.wants;
  out[4] = l.subclients;
  out[5] = static_cast<double>(l.priority);
  return 1;
}

// Request-path combo read: one locked call returns the client's lease
// AND the resource aggregates — the scalar per-request algorithms need
// both, and paying a ctypes crossing per field read dominated the
// immediate-mode serving path. out = {found, expiry, refresh_interval,
// has, wants, subclients, priority, sum_has, sum_wants, count}; absent
// clients report found=0 with zeroed lease fields (aggregates still
// filled).
void dm_peek(Engine *e, int32_t rid, int64_t cid, double *out) {
  std::lock_guard<std::mutex> lock(e->mu);
  std::fill(out, out + 10, 0.0);
  if (!valid_rid(e, rid)) return;
  const ResourceStore &r = e->resources[rid];
  out[7] = r.sum_has;
  out[8] = r.sum_wants;
  out[9] = static_cast<double>(r.count);
  auto it = r.index.find(cid);
  if (it == r.index.end()) return;
  const Lease &l = r.leases[it->second];
  out[0] = 1.0;
  out[1] = l.expiry;
  out[2] = l.refresh_interval;
  out[3] = l.has;
  out[4] = l.wants;
  out[5] = static_cast<double>(l.subclients);
  out[6] = static_cast<double>(l.priority);
}

// Batch-mode request path in ONE locked call: if the client holds a
// lease, record its new demand (wants/subclients/priority) and stamp a
// fresh expiry while PRESERVING the granted has — a batch server
// serves the last tick's solved grant and only notes demand; the tick
// recomputes (server.py _decide). Writes the served has to *has_out
// and returns 1; returns 0 when the client is unknown (the caller
// falls to the decide path, which admits new clients).
int32_t dm_refresh_grant(Engine *e, int32_t rid, int64_t cid,
                         double expiry, double refresh_interval,
                         double wants, int32_t subclients,
                         int64_t priority, double *has_out) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  ResourceStore &r = e->resources[rid];
  auto it = r.index.find(cid);
  if (it == r.index.end()) return 0;
  const double has = r.leases[it->second].has;
  upsert(e, rid, cid,
         Lease{expiry, refresh_interval, has, wants, subclients,
               priority});
  *has_out = has;
  return 1;
}

// Whole per-request decide in ONE locked call: expiry sweep, the
// scalar algorithm, and the lease upsert — the immediate-mode serving
// path (reference go/server/doorman/server.go:732-817) without a ctypes
// crossing per primitive store read. The arithmetic REPLICATES
// doorman_tpu/algorithms/scalar.py expression-for-expression (including
// association order), so grants are bit-identical to the Python oracle;
// the parity test asserts exact equality. `kind`: 0 NO_ALGORITHM,
// 1 STATIC, 2 PROPORTIONAL_SHARE, 3 FAIR_SHARE, 4 PROPORTIONAL_TOPUP,
// 6 LEARN (NOT 5 — that is AlgoKind.PRIORITY_BANDS, which must never
// route here; unknown kinds return 0 and the caller stays on the
// Python path). out = {gets, confused(FAIR_SHARE has-mismatch),
// old_has}.
// Returns 1 (always decides; unknown kinds fall back Python-side and
// never reach here).
int32_t dm_decide(Engine *e, int32_t rid, int64_t cid, int32_t kind,
                  double capacity, double now, double lease_length,
                  double refresh_interval, double has, double wants,
                  int32_t subclients, int64_t priority, double *out) {
  std::lock_guard<std::mutex> lock(e->mu);
  out[0] = out[1] = out[2] = 0.0;
  if (!valid_rid(e, rid)) return 0;
  ResourceStore &r = e->resources[rid];
  if (sweep_resource(e, rid, r, now)) mark_dirty(e, rid);

  auto it = r.index.find(cid);
  const bool found = it != r.index.end();
  const Lease old =
      found ? r.leases[it->second]
            : Lease{0.0, 0.0, 0.0, 0.0, 0, 0};
  out[2] = old.has;

  double gets = 0.0;
  switch (kind) {
    case 0:  // NO_ALGORITHM: everyone gets what they want.
      gets = wants;
      break;
    case 1:  // STATIC: per-client configured cap.
      gets = std::min(capacity, wants);
      break;
    case 6:  // LEARN: replay the client's reported grant.
      gets = has;
      break;
    case 2: {  // PROPORTIONAL_SHARE (scalar.py:92-104 order).
      const double all_wants = r.sum_wants - old.wants + wants;
      const double sum_leases = r.sum_has - old.has;
      const double free_cap = std::max(capacity - sum_leases, 0.0);
      if (all_wants < capacity) {
        gets = std::min(wants, free_cap);
      } else {
        gets = std::min(wants * (capacity / all_wants), free_cap);
      }
      break;
    }
    case 4: {  // PROPORTIONAL_TOPUP (scalar.py:116-158 order).
      double count = static_cast<double>(r.count);
      if (!found) count += subclients;
      const double equal_share = capacity / count;
      const double equal_share_client = equal_share * subclients;
      const double unused = capacity - r.sum_has + old.has;
      if (r.sum_wants <= capacity || wants <= equal_share_client) {
        gets = std::min(wants, unused);
        break;
      }
      double extra_capacity = 0.0;
      double extra_need = 0.0;
      for (size_t j = 0; j < r.leases.size(); ++j) {
        double w, s;
        if (r.clients[j] == cid) {
          w = wants;
          s = subclients;
        } else {
          w = r.leases[j].wants;
          s = r.leases[j].subclients;
        }
        const double share = equal_share * s;
        if (w < share) {
          extra_capacity += share - w;
        } else {
          extra_need += w - share;
        }
      }
      // An absent requester contributes nothing to the pools — the
      // Python loop iterates store.items(), substituting the fresh
      // request only for a slot the requester already holds.
      gets = equal_share_client +
             (wants - equal_share_client) * (extra_capacity / extra_need);
      gets = std::min(gets, unused);
      break;
    }
    case 3: {  // FAIR_SHARE (scalar.py:170-226 order).
      if (has != old.has) out[1] = 1.0;  // caller logs "confused"
      const double count =
          static_cast<double>(r.count) - old.subclients + subclients;
      const double available = capacity - r.sum_has + old.has;
      const double equal_share = capacity / count;
      const double deserved = equal_share * subclients;
      if (wants <= deserved) {
        gets = std::min(wants, available);
        break;
      }
      double extra = 0.0;
      double want_extra = subclients;
      for (size_t j = 0; j < r.leases.size(); ++j) {
        if (r.clients[j] == cid) continue;
        const Lease &l = r.leases[j];
        const double their_deserved = l.subclients * equal_share;
        if (l.wants < their_deserved) {
          extra += their_deserved - l.wants;
        } else if (l.wants > their_deserved) {
          want_extra += l.subclients;
        }
      }
      const double deserved_extra = (extra / want_extra) * subclients;
      if (wants < deserved + deserved_extra) {
        gets = std::min(wants, available);
        break;
      }
      double extra_extra = 0.0;
      double want_extra_extra = subclients;
      for (size_t j = 0; j < r.leases.size(); ++j) {
        if (r.clients[j] == cid) continue;
        const Lease &l = r.leases[j];
        const double their_deserved = l.subclients * equal_share;
        if (!(l.wants > their_deserved)) continue;  // round-1 subset
        const double entitled = deserved_extra + deserved;
        if (l.wants < entitled) {
          extra_extra += entitled - l.wants;
        } else if (l.wants > entitled) {
          want_extra_extra += l.subclients;
        }
      }
      const double deserved_extra_extra =
          (extra_extra / want_extra_extra) * subclients;
      gets = std::min(deserved + deserved_extra + deserved_extra_extra,
                      available);
      break;
    }
    default:
      return 0;
  }

  upsert(e, rid, cid,
         Lease{now + lease_length, refresh_interval, gets, wants,
               subclients, priority});
  out[0] = gets;
  return 1;
}

// Dump one resource's leases (store order). Arrays must hold
// dm_sums(...)[3] entries; returns the number written.
int64_t dm_dump(Engine *e, int32_t rid, int64_t *cids, double *expiry,
                double *refresh, double *has, double *wants,
                int32_t *subclients, int64_t *priority, int64_t cap) {
  std::lock_guard<std::mutex> lock(e->mu);
  if (!valid_rid(e, rid)) return 0;
  const ResourceStore &r = e->resources[rid];
  const int64_t n =
      std::min<int64_t>(cap, static_cast<int64_t>(r.leases.size()));
  for (int64_t i = 0; i < n; ++i) {
    const Lease &l = r.leases[i];
    cids[i] = r.clients[i];
    expiry[i] = l.expiry;
    refresh[i] = l.refresh_interval;
    has[i] = l.has;
    wants[i] = l.wants;
    subclients[i] = l.subclients;
    priority[i] = l.priority;
  }
  return n;
}

// Largest per-resource lease count (the dense bucket width the
// resident solver would need).
int64_t dm_max_leases(Engine *e) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t m = 0;
  for (const ResourceStore &r : e->resources)
    m = std::max<int64_t>(m, static_cast<int64_t>(r.leases.size()));
  return m;
}

int64_t dm_total_leases(Engine *e) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t total = 0;
  for (const ResourceStore &r : e->resources)
    total += static_cast<int64_t>(r.leases.size());
  return total;
}

// Bulk snapshot pack: edges laid out resource-major following `order`
// (engine resource handles, e.g. the batch solver's spec order).
// ridx_out[i] is the POSITION in `order` (the solver's segment id), not
// the engine handle. Returns edges written (<= cap).
int64_t dm_pack(Engine *e, const int32_t *order, int32_t n_order,
                int32_t *ridx_out, int64_t *cid_out, double *wants_out,
                double *has_out, double *sub_out, int64_t *prio_out,
                int64_t cap) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t w = 0;
  for (int32_t i = 0; i < n_order; ++i) {
    if (!valid_rid(e, order[i])) continue;
    const ResourceStore &r = e->resources[order[i]];
    const size_t n = r.leases.size();
    for (size_t j = 0; j < n; ++j) {
      if (w >= cap) return w;
      const Lease &l = r.leases[j];
      ridx_out[w] = i;
      cid_out[w] = r.clients[j];
      wants_out[w] = l.wants;
      has_out[w] = l.has;
      sub_out[w] = l.subclients;
      prio_out[w] = l.priority;
      ++w;
    }
  }
  return w;
}

// Bulk grant write-back after a solve: for each edge, if the client
// still holds a lease, set has=gets; everything else — expiry, refresh,
// wants, subclients, priority — keeps its CURRENT store value, so
// demand that changed while the solve was in flight is preserved and
// leases expire on the client's own refresh schedule (same grants-only
// semantics as dm_apply_dense). order[seg] < 0 skips that segment (its
// resource vanished mid-solve); keep_has[seg] != 0 leaves even has
// untouched (learning-mode resources replay the reported grant).
// applied_out[i] is 1 where the edge was written. Returns the number
// applied.
int64_t dm_apply(Engine *e, const int32_t *order, int32_t n_order,
                 const int32_t *ridx, const int64_t *cid,
                 const double *gets, int64_t n_edges,
                 const uint8_t *keep_has, uint8_t *applied_out) {
  std::lock_guard<std::mutex> lock(e->mu);
  int64_t applied = 0;
  for (int64_t i = 0; i < n_edges; ++i) {
    applied_out[i] = 0;
    const int32_t seg = ridx[i];
    if (seg < 0 || seg >= n_order || !valid_rid(e, order[seg])) continue;
    ResourceStore &r = e->resources[order[seg]];
    auto it = r.index.find(cid[i]);
    if (it == r.index.end()) continue;  // released mid-solve
    Lease &l = r.leases[it->second];
    if (!keep_has[seg]) {
      r.sum_has += gets[i] - l.has;
      l.has = gets[i];
    }
    applied_out[i] = 1;
    ++applied;
  }
  return applied;
}

}  // extern "C"
