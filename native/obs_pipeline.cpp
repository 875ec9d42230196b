// Native observation-ingest pipeline: background file parsing +
// shard-bucketing with a bounded prefetch ring.
//
// Role (SURVEY §5.8 / build brief "native data-loader"): the reference
// leans on dask's lazy task graph to overlap observation IO with compute
// (pytassim feeds xarray datasets straight into apply_ufunc). This
// rebuild runs one jitted SPMD program instead, so IO overlap must come
// from the HOST runtime: this pipeline reads + buckets the NEXT cycle's
// observation files on C++ threads while the current analysis runs on the
// chip, handing Python fully-bucketed per-shard arrays (the layout of
// tpu_assim.parallel.halo.shard_observations) ready for device_put.
//
// File format (one observation batch per file, little-endian):
//   magic  "TAOB"            4 bytes
//   int64  n_obs, n_dims
//   f64    vals[n_obs]
//   f64    var[n_obs]
//   int64  grid_idx[n_obs]          (global grid column of each obs)
//   f64    coords[n_obs * n_dims]
//
// Threading: `depth` worker threads each claim the next unread file
// (atomic ticket), parse + bucket it into a ring slot, and mark it ready;
// the consumer (`obs_loader_next`) waits on slot (seq % depth) so files
// are delivered in submission order while up to `depth` files parse
// concurrently — the classic bounded-prefetch pipeline.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<double> vals, var, coords, valid;
  std::vector<int32_t> lidx;
  int64_t file_index = -1;
  int status = 0;  // 0 empty, 1 ready, <0 error codes
  bool filled = false;
};

struct Loader {
  std::vector<std::string> paths;
  int64_t n_grid = 0, n_shards = 0, cap = 0, n_dims = 0;
  int depth = 0;
  std::vector<Slot> ring;
  std::vector<std::thread> workers;
  std::atomic<int64_t> ticket{0};
  int64_t next_out = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  bool closing = false;
};

// Parse one file and bucket into per-shard fixed-capacity arrays
// (layout identical to parallel/halo.py:shard_observations: values and
// variances padded with zeros, validity 1.0 on real slots, local index =
// global index - shard * shard_size).
int parse_and_bucket(Loader* L, const std::string& path, Slot* s) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return -2;
  char magic[4];
  int64_t n_obs = 0, n_dims = 0;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "TAOB", 4) ||
      std::fread(&n_obs, 8, 1, f) != 1 || std::fread(&n_dims, 8, 1, f) != 1 ||
      n_obs < 0 || n_dims != L->n_dims) {
    std::fclose(f);
    return -3;
  }
  std::vector<double> vals(n_obs), var(n_obs), coords(n_obs * n_dims);
  std::vector<int64_t> gidx(n_obs);
  bool ok = std::fread(vals.data(), 8, n_obs, f) == (size_t)n_obs &&
            std::fread(var.data(), 8, n_obs, f) == (size_t)n_obs &&
            std::fread(gidx.data(), 8, n_obs, f) == (size_t)n_obs &&
            std::fread(coords.data(), 8, n_obs * n_dims, f) ==
                (size_t)(n_obs * n_dims);
  std::fclose(f);
  if (!ok) return -3;

  const int64_t S = L->n_shards, cap = L->cap, d = L->n_dims;
  const int64_t shard_size = L->n_grid / S;
  s->vals.assign(S * cap, 0.0);
  s->var.assign(S * cap, 1.0);  // padded slots: unit variance, zero valid
  s->valid.assign(S * cap, 0.0);
  s->coords.assign(S * cap * d, 0.0);
  s->lidx.assign(S * cap, 0);
  std::vector<int64_t> fill(S, 0);
  for (int64_t i = 0; i < n_obs; ++i) {
    if (gidx[i] < 0 || gidx[i] >= L->n_grid) return -4;
    int64_t sh = gidx[i] / shard_size;
    if (sh >= S) sh = S - 1;
    int64_t k = fill[sh]++;
    if (k >= cap) return -5;  // capacity overflow: caller must raise cap
    int64_t at = sh * cap + k;
    s->vals[at] = vals[i];
    s->var[at] = var[i];
    s->valid[at] = 1.0;
    s->lidx[at] = (int32_t)(gidx[i] - sh * shard_size);
    for (int64_t j = 0; j < d; ++j)
      s->coords[at * d + j] = coords[i * d + j];
  }
  return 1;
}

void worker(Loader* L) {
  for (;;) {
    int64_t t = L->ticket.fetch_add(1);
    if (t >= (int64_t)L->paths.size()) return;
    Slot* s = &L->ring[t % L->depth];
    {
      // wait until the consumer drained this slot's previous occupant
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_free.wait(lk, [&] { return L->closing || !s->filled; });
      if (L->closing) return;
    }
    int st = parse_and_bucket(L, L->paths[t], s);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      s->file_index = t;
      s->status = st;
      s->filled = true;
    }
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* obs_loader_open(const char** paths, int64_t n_paths, int64_t n_grid,
                      int64_t n_shards, int64_t cap, int64_t n_dims,
                      int64_t depth) {
  if (n_shards <= 0 || n_grid <= 0 || n_grid % n_shards || cap <= 0 ||
      depth <= 0)
    return nullptr;
  auto* L = new Loader();
  for (int64_t i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->n_grid = n_grid;
  L->n_shards = n_shards;
  L->cap = cap;
  L->n_dims = n_dims;
  L->depth = (int)(depth < n_paths ? depth : (n_paths ? n_paths : 1));
  L->ring.resize(L->depth);
  for (int i = 0; i < L->depth; ++i)
    L->workers.emplace_back(worker, L);
  return L;
}

// Blocks until the next file (in submission order) is bucketed; copies it
// into the caller's arrays ([n_shards * cap] / [n_shards * cap * n_dims]).
// Returns the file index, -1 when exhausted, or the parse error code.
int64_t obs_loader_next(void* h, double* vals, double* var, int32_t* lidx,
                        double* coords, double* valid) {
  auto* L = (Loader*)h;
  if (L->next_out >= (int64_t)L->paths.size()) return -1;
  Slot* s = &L->ring[L->next_out % L->depth];
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] { return s->filled && s->file_index == L->next_out; });
  int64_t ret = s->status < 0 ? s->status : s->file_index;
  if (s->status >= 0) {
    const int64_t n = L->n_shards * L->cap;
    std::memcpy(vals, s->vals.data(), n * 8);
    std::memcpy(var, s->var.data(), n * 8);
    std::memcpy(valid, s->valid.data(), n * 8);
    std::memcpy(lidx, s->lidx.data(), n * 4);
    std::memcpy(coords, s->coords.data(), n * L->n_dims * 8);
  }
  s->filled = false;
  s->status = 0;
  ++L->next_out;
  lk.unlock();
  L->cv_free.notify_all();
  return ret;
}

void obs_loader_close(void* h) {
  auto* L = (Loader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closing = true;
  }
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot writer for the TAOB format (tests + experiment tooling).
int64_t obs_file_write(const char* path, const double* vals,
                       const double* var, const int64_t* gidx,
                       const double* coords, int64_t n_obs, int64_t n_dims) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  bool ok = std::fwrite("TAOB", 1, 4, f) == 4 &&
            std::fwrite(&n_obs, 8, 1, f) == 1 &&
            std::fwrite(&n_dims, 8, 1, f) == 1 &&
            std::fwrite(vals, 8, n_obs, f) == (size_t)n_obs &&
            std::fwrite(var, 8, n_obs, f) == (size_t)n_obs &&
            std::fwrite(gidx, 8, n_obs, f) == (size_t)n_obs &&
            std::fwrite(coords, 8, n_obs * n_dims, f) ==
                (size_t)(n_obs * n_dims);
  std::fclose(f);
  return ok ? 0 : -3;
}

}  // extern "C"
