// Native KITTI scan loader + prefetcher.
//
// The reference's data path is a C++ ROS node (kittiHelper.cpp:25-35:
// binary float32 reads republished as PointCloud2). Here the native layer
// is a small C library driven through ctypes: it reads the float32 .bin
// scans, pads/masks them into fixed-capacity buffers ready for device
// upload, and runs a multi-threaded read-ahead ring so the accelerator
// never waits on disk.
//
// Build: g++ -O3 -shared -fPIC -o libkitti_loader.so kitti_loader.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
    long index = -1;
    std::vector<float> xyz;    // n_pad * 3
    std::vector<float> refl;   // n_pad
    std::vector<unsigned char> mask;  // n_pad
    int n_valid = 0;
    bool ok = false;
};

// Read one .bin (x,y,z,reflectance float32 quads) into padded buffers.
bool read_frame(const std::string& path, int n_pad, Frame* f) {
    FILE* fp = std::fopen(path.c_str(), "rb");
    if (!fp) return false;
    std::fseek(fp, 0, SEEK_END);
    long bytes = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    long n_pts = bytes / (4 * sizeof(float));
    std::vector<float> raw(static_cast<size_t>(n_pts) * 4);
    size_t got = std::fread(raw.data(), sizeof(float), raw.size(), fp);
    std::fclose(fp);
    if (got != raw.size()) return false;

    int n = static_cast<int>(n_pts < n_pad ? n_pts : n_pad);
    f->xyz.assign(static_cast<size_t>(n_pad) * 3, 0.0f);
    f->refl.assign(n_pad, 0.0f);
    f->mask.assign(n_pad, 0);
    for (int i = 0; i < n; ++i) {
        f->xyz[3 * i + 0] = raw[4 * i + 0];
        f->xyz[3 * i + 1] = raw[4 * i + 1];
        f->xyz[3 * i + 2] = raw[4 * i + 2];
        f->refl[i] = raw[4 * i + 3];
        f->mask[i] = 1;
    }
    f->n_valid = n;
    return true;
}

struct Prefetcher {
    std::vector<std::string> paths;
    int n_pad;
    int depth;

    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::queue<Frame> ready;        // frames in order
    long next_to_read = 0;          // next index a worker may claim
    long next_to_emit = 0;          // next index next() returns
    std::vector<Frame> landing;     // out-of-order landing zone
    std::vector<bool> landed;
    std::atomic<bool> stop{false};
    std::vector<std::thread> workers;

    Prefetcher(std::vector<std::string> p, int pad, int d, int n_threads)
        : paths(std::move(p)), n_pad(pad), depth(d),
          landing(paths.size()), landed(paths.size(), false) {
        for (int t = 0; t < n_threads; ++t)
            workers.emplace_back([this] { work(); });
    }

    ~Prefetcher() {
        stop = true;
        cv_space.notify_all();
        cv_ready.notify_all();
        for (auto& w : workers) w.join();
    }

    void work() {
        while (!stop) {
            long idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [this] {
                    return stop ||
                        (next_to_read < (long)paths.size() &&
                         next_to_read - next_to_emit < depth);
                });
                if (stop || next_to_read >= (long)paths.size()) return;
                idx = next_to_read++;
            }
            Frame f;
            f.index = idx;
            f.ok = read_frame(paths[idx], n_pad, &f);
            {
                std::lock_guard<std::mutex> lk(mu);
                landing[idx] = std::move(f);
                landed[idx] = true;
            }
            cv_ready.notify_all();
        }
    }

    // Blocks until the next in-order frame is ready. Returns n_valid,
    // -1 at end of sequence, -2 on read error.
    int next(float* xyz, unsigned char* mask, float* refl) {
        std::unique_lock<std::mutex> lk(mu);
        if (next_to_emit >= (long)paths.size()) return -1;
        long idx = next_to_emit;
        cv_ready.wait(lk, [this, idx] { return stop || landed[idx]; });
        if (stop) return -1;
        Frame f = std::move(landing[idx]);
        landed[idx] = false;
        next_to_emit++;
        cv_space.notify_all();
        lk.unlock();
        if (!f.ok) return -2;
        std::memcpy(xyz, f.xyz.data(), f.xyz.size() * sizeof(float));
        std::memcpy(refl, f.refl.data(), f.refl.size() * sizeof(float));
        std::memcpy(mask, f.mask.data(), f.mask.size());
        return f.n_valid;
    }
};

}  // namespace

extern "C" {

// One-shot read: returns number of valid points, or -1 on error.
int kl_read_bin(const char* path, int n_pad, float* xyz,
                unsigned char* mask, float* refl) {
    Frame f;
    if (!read_frame(path, n_pad, &f)) return -1;
    std::memcpy(xyz, f.xyz.data(), f.xyz.size() * sizeof(float));
    std::memcpy(refl, f.refl.data(), f.refl.size() * sizeof(float));
    std::memcpy(mask, f.mask.data(), f.mask.size());
    return f.n_valid;
}

void* kl_prefetcher_create(const char** paths, int n, int n_pad,
                           int queue_depth, int n_threads) {
    std::vector<std::string> p(paths, paths + n);
    return new Prefetcher(std::move(p), n_pad, queue_depth, n_threads);
}

int kl_prefetcher_next(void* h, float* xyz, unsigned char* mask,
                       float* refl) {
    return static_cast<Prefetcher*>(h)->next(xyz, mask, refl);
}

void kl_prefetcher_destroy(void* h) { delete static_cast<Prefetcher*>(h); }

}  // extern "C"
