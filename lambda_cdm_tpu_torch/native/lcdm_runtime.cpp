// lcdm_runtime: native host-side runtime for lambda_cdm_tpu.
//
// The reference's C++ runtime layer is largely unimplemented scaffolding:
//   * ComponentRegistry::topological_sort is a passthrough and
//     detect_circular_dependencies always returns false
//     (src/core/component_registry.cpp:212-234);
//   * GPUResourceManager/MemoryPool is a 247-line header with no
//     implementation file (include/core/resource_manager.hpp);
//   * snapshot/checkpoint I/O always returns false
//     (src/core/simulation_engine.cpp:255-258).
//
// This library implements those capabilities for real, as the host-side
// native runtime of the TPU framework (the TPU compute path is JAX/XLA;
// this covers the runtime-around-the-compute: dependency resolution,
// host staging-buffer management, and a threaded binary snapshot codec
// playing the data-loader role).
//
// Exposed as a plain C ABI consumed through ctypes
// (lambda_cdm_tpu/native/__init__.py). Build: native/build.sh (g++17).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#define LCDM_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// Component registry: name -> id, dependency edges, Kahn topological sort
// with genuine cycle detection.
// ---------------------------------------------------------------------------

namespace {

struct Registry {
    std::mutex mu;
    std::unordered_map<std::string, int> ids;
    std::vector<std::string> names;
    std::vector<std::vector<int>> deps;  // deps[a] = components a needs
};

}  // namespace

LCDM_API void* lcdm_registry_create() { return new Registry(); }

LCDM_API void lcdm_registry_destroy(void* h) {
    delete static_cast<Registry*>(h);
}

LCDM_API int lcdm_registry_add(void* h, const char* name) {
    auto* r = static_cast<Registry*>(h);
    std::lock_guard<std::mutex> lock(r->mu);
    auto it = r->ids.find(name);
    if (it != r->ids.end()) return it->second;
    int id = static_cast<int>(r->names.size());
    r->ids.emplace(name, id);
    r->names.emplace_back(name);
    r->deps.emplace_back();
    return id;
}

LCDM_API int lcdm_registry_count(void* h) {
    auto* r = static_cast<Registry*>(h);
    std::lock_guard<std::mutex> lock(r->mu);
    return static_cast<int>(r->names.size());
}

// `name` depends on `dep` (dep must initialize first). Returns 0, or -1 if
// either component is unknown.
LCDM_API int lcdm_registry_add_dependency(void* h, const char* name,
                                          const char* dep) {
    auto* r = static_cast<Registry*>(h);
    std::lock_guard<std::mutex> lock(r->mu);
    auto a = r->ids.find(name);
    auto b = r->ids.find(dep);
    if (a == r->ids.end() || b == r->ids.end()) return -1;
    r->deps[a->second].push_back(b->second);
    return 0;
}

// Kahn's algorithm. Writes the initialization order (dependencies first)
// into out_ids. Returns the count, or -1 on a dependency cycle
// (the capability component_registry.cpp:212-222 stubbed out).
LCDM_API int lcdm_registry_topo_sort(void* h, int* out_ids, int max_out) {
    auto* r = static_cast<Registry*>(h);
    std::lock_guard<std::mutex> lock(r->mu);
    const int n = static_cast<int>(r->names.size());
    if (n > max_out) return -2;
    std::vector<int> indegree(n, 0);
    std::vector<std::vector<int>> dependents(n);
    for (int a = 0; a < n; ++a) {
        for (int b : r->deps[a]) {
            ++indegree[a];
            dependents[b].push_back(a);
        }
    }
    std::queue<int> ready;
    for (int i = 0; i < n; ++i)
        if (indegree[i] == 0) ready.push(i);
    int count = 0;
    while (!ready.empty()) {
        int v = ready.front();
        ready.pop();
        out_ids[count++] = v;
        for (int w : dependents[v])
            if (--indegree[w] == 0) ready.push(w);
    }
    return count == n ? count : -1;  // -1: cycle
}

LCDM_API int lcdm_registry_has_cycle(void* h) {
    std::vector<int> scratch(lcdm_registry_count(h));
    int rc = lcdm_registry_topo_sort(h, scratch.data(),
                                     static_cast<int>(scratch.size()));
    return rc == -1 ? 1 : 0;
}

LCDM_API const char* lcdm_registry_name(void* h, int id) {
    auto* r = static_cast<Registry*>(h);
    std::lock_guard<std::mutex> lock(r->mu);
    if (id < 0 || id >= static_cast<int>(r->names.size())) return nullptr;
    return r->names[id].c_str();
}

// ---------------------------------------------------------------------------
// Arena/pool allocator for host staging buffers with usage statistics
// (the MemoryPool capability of include/core/resource_manager.hpp:14-246,
// which had no implementation file).
// ---------------------------------------------------------------------------

namespace {

struct Pool {
    std::mutex mu;
    std::vector<uint8_t> storage;
    size_t used = 0;
    size_t peak = 0;
    size_t n_allocs = 0;
};

}  // namespace

LCDM_API void* lcdm_pool_create(size_t capacity) {
    auto* p = new Pool();
    p->storage.resize(capacity);
    return p;
}

LCDM_API void lcdm_pool_destroy(void* h) { delete static_cast<Pool*>(h); }

LCDM_API void* lcdm_pool_alloc(void* h, size_t size, size_t align) {
    auto* p = static_cast<Pool*>(h);
    std::lock_guard<std::mutex> lock(p->mu);
    if (align == 0) align = 64;
    // align the ABSOLUTE address, not just the offset
    auto base = reinterpret_cast<uintptr_t>(p->storage.data());
    uintptr_t addr = (base + p->used + align - 1) / align * align;
    size_t offset = addr - base;
    if (offset + size > p->storage.size()) return nullptr;
    p->used = offset + size;
    if (p->used > p->peak) p->peak = p->used;
    ++p->n_allocs;
    return p->storage.data() + offset;
}

LCDM_API void lcdm_pool_reset(void* h) {
    auto* p = static_cast<Pool*>(h);
    std::lock_guard<std::mutex> lock(p->mu);
    p->used = 0;
}

LCDM_API size_t lcdm_pool_used(void* h) {
    return static_cast<Pool*>(h)->used;
}
LCDM_API size_t lcdm_pool_capacity(void* h) {
    return static_cast<Pool*>(h)->storage.size();
}
LCDM_API size_t lcdm_pool_peak(void* h) {
    return static_cast<Pool*>(h)->peak;
}
LCDM_API size_t lcdm_pool_alloc_count(void* h) {
    return static_cast<Pool*>(h)->n_allocs;
}

// ---------------------------------------------------------------------------
// Binary snapshot codec (.lcdm format) with FNV-1a integrity checksum.
// Layout: header{magic, version, n, scale_factor, time, step, checksum}
// followed by pos[3n] f32, vel[3n] f32, mass[n] f32.
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kMagic = 0x4c43444d534e5031ull;  // "LCDMSNP1"

struct SnapshotHeader {
    uint64_t magic;
    uint32_t version;
    uint32_t reserved;
    int64_t n;
    double scale_factor;
    double time;
    int64_t step;
    uint64_t checksum;
};

uint64_t fnv1a(const uint8_t* data, size_t len, uint64_t h = 1469598103934665603ull) {
    for (size_t i = 0; i < len; ++i) {
        h ^= data[i];
        h *= 1099511628211ull;
    }
    return h;
}

uint64_t snapshot_checksum(int64_t n, const float* pos, const float* vel,
                           const float* mass) {
    uint64_t h = fnv1a(reinterpret_cast<const uint8_t*>(pos),
                       sizeof(float) * 3 * n);
    h = fnv1a(reinterpret_cast<const uint8_t*>(vel),
              sizeof(float) * 3 * n, h);
    h = fnv1a(reinterpret_cast<const uint8_t*>(mass), sizeof(float) * n, h);
    return h;
}

}  // namespace

LCDM_API int lcdm_snapshot_write(const char* path, int64_t n,
                                 const float* pos, const float* vel,
                                 const float* mass, double scale_factor,
                                 double time, int64_t step) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    SnapshotHeader hdr{};
    hdr.magic = kMagic;
    hdr.version = 1;
    hdr.n = n;
    hdr.scale_factor = scale_factor;
    hdr.time = time;
    hdr.step = step;
    hdr.checksum = snapshot_checksum(n, pos, vel, mass);
    int ok = std::fwrite(&hdr, sizeof(hdr), 1, f) == 1 &&
             std::fwrite(pos, sizeof(float), 3 * n, f) ==
                 static_cast<size_t>(3 * n) &&
             std::fwrite(vel, sizeof(float), 3 * n, f) ==
                 static_cast<size_t>(3 * n) &&
             std::fwrite(mass, sizeof(float), n, f) ==
                 static_cast<size_t>(n);
    std::fclose(f);
    return ok ? 0 : -2;
}

LCDM_API int64_t lcdm_snapshot_read_n(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    SnapshotHeader hdr{};
    size_t got = std::fread(&hdr, sizeof(hdr), 1, f);
    std::fclose(f);
    if (got != 1 || hdr.magic != kMagic) return -2;
    return hdr.n;
}

// Returns 0 on success, -3 on checksum mismatch (corruption detection --
// the failure-detection capability the reference lacks, SURVEY.md sec. 5).
LCDM_API int lcdm_snapshot_read(const char* path, int64_t n, float* pos,
                                float* vel, float* mass,
                                double* scale_factor, double* time,
                                int64_t* step) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    SnapshotHeader hdr{};
    if (std::fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != kMagic ||
        hdr.n != n) {
        std::fclose(f);
        return -2;
    }
    int ok = std::fread(pos, sizeof(float), 3 * n, f) ==
                 static_cast<size_t>(3 * n) &&
             std::fread(vel, sizeof(float), 3 * n, f) ==
                 static_cast<size_t>(3 * n) &&
             std::fread(mass, sizeof(float), n, f) ==
                 static_cast<size_t>(n);
    std::fclose(f);
    if (!ok) return -2;
    if (snapshot_checksum(n, pos, vel, mass) != hdr.checksum) return -3;
    *scale_factor = hdr.scale_factor;
    *time = hdr.time;
    *step = hdr.step;
    return 0;
}

// ---------------------------------------------------------------------------
// Async snapshot writer: a background worker thread drains a bounded queue
// so device->host snapshot dumps overlap simulation (the stream-overlap /
// data-loader role of the reference's CudaStreamPool,
// lambda_cdm_kernels.cu:411-441, on the host side).
// ---------------------------------------------------------------------------

namespace {

struct WriteJob {
    std::string path;
    std::vector<float> pos, vel, mass;
    double scale_factor, time;
    int64_t step;
};

struct Writer {
    std::mutex mu;
    std::condition_variable cv;
    std::queue<WriteJob> jobs;
    std::thread worker;
    std::atomic<int> pending{0};
    std::atomic<int> errors{0};
    bool stop = false;

    void run() {
        for (;;) {
            WriteJob job;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv.wait(lock, [&] { return stop || !jobs.empty(); });
                if (jobs.empty()) {
                    if (stop) return;
                    continue;
                }
                job = std::move(jobs.front());
                jobs.pop();
            }
            int rc = lcdm_snapshot_write(
                job.path.c_str(), static_cast<int64_t>(job.mass.size()),
                job.pos.data(), job.vel.data(), job.mass.data(),
                job.scale_factor, job.time, job.step);
            if (rc != 0) ++errors;
            --pending;
            cv.notify_all();
        }
    }
};

}  // namespace

LCDM_API void* lcdm_writer_create() {
    auto* w = new Writer();
    w->worker = std::thread([w] { w->run(); });
    return w;
}

LCDM_API int lcdm_writer_submit(void* h, const char* path, int64_t n,
                                const float* pos, const float* vel,
                                const float* mass, double scale_factor,
                                double time, int64_t step) {
    auto* w = static_cast<Writer*>(h);
    WriteJob job;
    job.path = path;
    job.pos.assign(pos, pos + 3 * n);
    job.vel.assign(vel, vel + 3 * n);
    job.mass.assign(mass, mass + n);
    job.scale_factor = scale_factor;
    job.time = time;
    job.step = step;
    {
        std::lock_guard<std::mutex> lock(w->mu);
        if (w->jobs.size() >= 8) return -1;  // bounded queue: caller waits
        w->jobs.push(std::move(job));
        ++w->pending;
    }
    w->cv.notify_all();
    return 0;
}

LCDM_API int lcdm_writer_pending(void* h) {
    return static_cast<Writer*>(h)->pending.load();
}

LCDM_API int lcdm_writer_errors(void* h) {
    return static_cast<Writer*>(h)->errors.load();
}

LCDM_API void lcdm_writer_wait(void* h) {
    auto* w = static_cast<Writer*>(h);
    std::unique_lock<std::mutex> lock(w->mu);
    w->cv.wait(lock, [&] { return w->pending.load() == 0; });
}

LCDM_API void lcdm_writer_destroy(void* h) {
    auto* w = static_cast<Writer*>(h);
    {
        std::lock_guard<std::mutex> lock(w->mu);
        w->stop = true;
    }
    w->cv.notify_all();
    w->worker.join();
    delete w;
}

LCDM_API const char* lcdm_runtime_version() { return "lcdm_runtime 1.0"; }
