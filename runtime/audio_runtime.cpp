// Native host runtime for audio_analyzer_rs_tpu.
//
// The reference (audio-analyzer-rs) runs its realtime fabric in Rust on the
// CPU: a SlotPool of refcounted buffers fanned out over SPSC rings to worker
// threads, with a reducer thread doing per-sample conditioning (biquads +
// noise gate) and AGC (ref src/audio_io/mod.rs:31-79,336-511, dynamics.rs).
// This library is the C++ equivalent: the sequential per-sample conditioning
// that would waste an accelerator runs here at memory bandwidth, feeding conditioned
// slots to the device for the batched FFT/feature work.
//
// Exposed C ABI (ctypes-friendly):
//   - spsc ring:      ring_create/destroy/push/pop/len
//   - slot pool:      pool_create/destroy/acquire/release/slot_ptr
//   - reducer+AGC:    reducer_create/destroy/process (conditions in place,
//                     fills a DynamicsOut per slot)
//   - pipeline:       pipeline_create/destroy/push_input/pull_slot —
//                     a reducer thread draining an input ring through
//                     conditioning into per-consumer rings (the reference's
//                     thread structure, one consumer here).
//
// Numerics follow the reference's f32 math exactly (biquad RBJ Q=0.707,
// gate -60 dB ratio^4 with 40 ms release / 20 ms hold, AGC p10/p50/p95
// percentile histories with -18 dBFS target).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ───────────────────────── SPSC ring buffer ──────────────────────────────
// Lock-free single-producer single-consumer ring of uint64 values
// (slot indices), mirroring rtrb's role (ref Cargo.toml:30, mod.rs:299-314).

struct Ring {
    std::vector<uint64_t> buf;
    size_t capacity;
    std::atomic<size_t> head{0};  // consumer position
    std::atomic<size_t> tail{0};  // producer position
};

Ring* ring_create(size_t capacity) {
    Ring* r = new Ring();
    r->capacity = capacity + 1;  // one empty slot distinguishes full/empty
    r->buf.resize(r->capacity);
    return r;
}

void ring_destroy(Ring* r) { delete r; }

int ring_push(Ring* r, uint64_t value) {
    size_t tail = r->tail.load(std::memory_order_relaxed);
    size_t next = (tail + 1) % r->capacity;
    if (next == r->head.load(std::memory_order_acquire)) return 0;  // full
    r->buf[tail] = value;
    r->tail.store(next, std::memory_order_release);
    return 1;
}

int ring_pop(Ring* r, uint64_t* out) {
    size_t head = r->head.load(std::memory_order_relaxed);
    if (head == r->tail.load(std::memory_order_acquire)) return 0;  // empty
    *out = r->buf[head];
    r->head.store((head + 1) % r->capacity, std::memory_order_release);
    return 1;
}

size_t ring_len(Ring* r) {
    size_t h = r->head.load(std::memory_order_acquire);
    size_t t = r->tail.load(std::memory_order_acquire);
    return (t + r->capacity - h) % r->capacity;
}

// ───────────────────────── Slot pool ─────────────────────────────────────
// Pool of reusable audio buffers with atomic refcount SPMC fan-out
// (ref mod.rs:31-79).

struct SlotPool {
    size_t pool_size;
    size_t slot_len;
    std::vector<float> storage;
    std::vector<std::atomic<uint32_t>> counts;

    SlotPool(size_t n, size_t len)
        : pool_size(n), slot_len(len), storage(n * len), counts(n) {}
};

SlotPool* pool_create(size_t pool_size, size_t slot_len) {
    return new SlotPool(pool_size, slot_len);
}

void pool_destroy(SlotPool* p) { delete p; }

float* pool_slot_ptr(SlotPool* p, size_t idx) {
    return p->storage.data() + idx * p->slot_len;
}

void pool_acquire(SlotPool* p, size_t idx, uint32_t consumers) {
    p->counts[idx].store(consumers, std::memory_order_seq_cst);
}

// Returns 1 when the count reached zero (slot reclaimable), 0 otherwise;
// -1 flags an underflow (ref mod.rs:62-78).
int pool_release(SlotPool* p, size_t idx) {
    uint32_t current = p->counts[idx].load(std::memory_order_seq_cst);
    while (true) {
        if (current == 0) return -1;
        if (p->counts[idx].compare_exchange_weak(
                current, current - 1, std::memory_order_seq_cst)) {
            return current == 1 ? 1 : 0;
        }
    }
}

// ───────────────────────── Reducer + AGC ─────────────────────────────────

struct Biquad {
    float b0, b1, b2, a1, a2;
    float x1 = 0, x2 = 0, y1 = 0, y2 = 0;

    void init(float freq, float sample_rate, bool is_lpf) {
        // RBJ with Q = 0.707, f32 math (ref mod.rs:351-377).  Cutoff clamped
        // below Nyquist (the reference NaNs out at rates < 2*cutoff); no-op
        // at standard rates — matches ops/reducer.py biquad_coeffs.
        if (freq > 0.45f * sample_rate) freq = 0.45f * sample_rate;
        float w0 = 2.0f * (float)M_PI * freq / sample_rate;
        float cw = std::cos(w0), sw = std::sin(w0);
        float alpha = sw / (2.0f * 0.707f);
        float rb0, rb1, rb2, ra0, ra1, ra2;
        if (is_lpf) {
            rb0 = (1.0f - cw) / 2.0f; rb1 = 1.0f - cw; rb2 = rb0;
        } else {
            rb0 = (1.0f + cw) / 2.0f; rb1 = -(1.0f + cw); rb2 = rb0;
        }
        ra0 = 1.0f + alpha; ra1 = -2.0f * cw; ra2 = 1.0f - alpha;
        b0 = rb0 / ra0; b1 = rb1 / ra0; b2 = rb2 / ra0;
        a1 = ra1 / ra0; a2 = ra2 / ra0;
    }

    inline float step(float x) {
        float y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
        x2 = x1; x1 = x; y2 = y1; y1 = y;
        return y;
    }
};

struct DynamicsOut {
    int32_t level;            // -1 silence .. 7 fff
    float rms_db;
    float gain_db;
    float session_median_db;
    float noise_floor_db;
};

struct Reducer {
    float sample_rate;
    size_t slot_len;
    Biquad hpf, lpf;
    // Gate (ref mod.rs:392-471).
    float gate_threshold;
    float envelope = 0.0f;
    float release_coeff;
    int hold_samples;
    int hold_remaining = 0;
    // AGC (ref dynamics.rs:140-360).
    static const int LONG_LEN = 256;
    static const int PLAY_LEN = 5000;
    float long_hist[LONG_LEN] = {0};
    int long_pos = 0; bool long_filled = false;
    float play_hist[PLAY_LEN] = {0};
    int play_pos = 0; bool play_filled = false;
    float gain_linear = 1.0f;
    float target_db = -18.0f, max_boost_db = 100.0f;
    float smooth_alpha, silence_alpha;
    std::vector<float> sort_buf;
};

static inline float lin_to_db(float v) {
    return 20.0f * std::log10(std::max(v, 1e-9f));
}

Reducer* reducer_create(float sample_rate, size_t slot_len) {
    Reducer* r = new Reducer();
    r->sample_rate = sample_rate;
    r->slot_len = slot_len;
    r->hpf.init(40.0f, sample_rate, false);
    r->lpf.init(14000.0f, sample_rate, true);
    r->gate_threshold = std::pow(10.0f, -60.0f / 20.0f);
    r->release_coeff = std::exp(-1.0f / (0.040f * sample_rate));
    r->hold_samples = (int)(0.020f * sample_rate);
    float slot_rate = sample_rate / (float)slot_len;
    r->smooth_alpha = 1.0f - std::exp(-1.0f / (240.0f * slot_rate));
    r->silence_alpha = 1.0f - std::exp(-1.0f / (10.0f * slot_rate));
    r->sort_buf.reserve(Reducer::PLAY_LEN);
    return r;
}

void reducer_destroy(Reducer* r) { delete r; }

// Condition one slot in place and fill the dynamics output.
void reducer_process(Reducer* r, float* slot, size_t n, DynamicsOut* out) {
    // 1. Biquads + gate, per sample (ref mod.rs:423-472).
    for (size_t i = 0; i < n; i++) {
        float x = r->lpf.step(r->hpf.step(slot[i]));
        float a = std::fabs(x);
        if (a > r->envelope) {
            r->envelope = a;
            r->hold_remaining = r->hold_samples;
        } else {
            r->envelope = r->release_coeff * r->envelope
                          + (1.0f - r->release_coeff) * a;
        }
        float gain;
        if (r->envelope >= r->gate_threshold) {
            gain = 1.0f;
        } else if (r->hold_remaining > 0) {
            r->hold_remaining--;
            gain = 1.0f;
        } else {
            float ratio = r->envelope / r->gate_threshold;
            gain = ratio * ratio * ratio * ratio;
        }
        slot[i] = x * gain;
    }

    // 2. AGC (ref dynamics.rs:194-360).
    float sum_sq = 0.0f;
    for (size_t i = 0; i < n; i++) sum_sq += slot[i] * slot[i];
    float rms_linear = std::sqrt(sum_sq / (float)n);
    float rms_db = lin_to_db(rms_linear);

    int long_n = r->long_filled ? Reducer::LONG_LEN : std::max(r->long_pos, 1);
    r->sort_buf.assign(r->long_hist, r->long_hist + long_n);
    std::sort(r->sort_buf.begin(), r->sort_buf.end());
    int p10_idx = (int)((long_n - 1) * 0.10f);
    float noise_floor_db = lin_to_db(std::max(r->sort_buf[p10_idx], 1e-9f));

    float floor_db = long_n >= 32 ? noise_floor_db : -55.0f;
    bool is_active = rms_db > floor_db + 20.0f;

    bool is_broadband = false;
    if (is_active) {
        float mean_sq = rms_linear * rms_linear;
        float mean_quad = 0.0f;
        for (size_t i = 0; i < n; i++) {
            float s2 = slot[i] * slot[i];
            mean_quad += s2 * s2;
        }
        mean_quad /= (float)n;
        float kurtosis = mean_sq > 1e-18f ? mean_quad / (mean_sq * mean_sq)
                                          : 3.0f;
        is_broadband = kurtosis >= 2.75f && kurtosis <= 3.8f && rms_db < -45.0f;
    }
    bool is_playing = is_active && !is_broadband;

    if (!is_active || is_broadband) {
        r->long_hist[r->long_pos] = rms_linear;
        r->long_pos = (r->long_pos + 1) % Reducer::LONG_LEN;
        if (r->long_pos == 0) r->long_filled = true;
    }
    if (is_playing) {
        r->play_hist[r->play_pos] = rms_linear;
        r->play_pos = (r->play_pos + 1) % Reducer::PLAY_LEN;
        if (r->play_pos == 0) r->play_filled = true;
    }

    int play_n = r->play_filled ? Reducer::PLAY_LEN : r->play_pos;
    float raw_gain_db = 0.0f, median_db = rms_db;
    if (play_n > 0) {
        r->sort_buf.assign(r->play_hist, r->play_hist + play_n);
        std::sort(r->sort_buf.begin(), r->sort_buf.end());
        int p50_idx = (play_n - 1) / 2;
        int p95_idx = (int)((play_n - 1) * 0.95f);
        median_db = lin_to_db(std::max(r->sort_buf[p50_idx], 1e-9f));
        float p95_db = lin_to_db(std::max(r->sort_buf[p95_idx], 1e-9f));
        raw_gain_db = std::clamp(r->target_db - p95_db, 0.0f, r->max_boost_db);
    }

    if (is_playing) {
        float target_linear = std::pow(10.0f, raw_gain_db / 20.0f);
        r->gain_linear += r->smooth_alpha * (target_linear - r->gain_linear);
    } else {
        r->gain_linear += r->silence_alpha * (1.0f - r->gain_linear);
    }

    float peak = 1e-9f;
    for (size_t i = 0; i < n; i++) peak = std::max(peak, std::fabs(slot[i]));
    float effective = std::min(r->gain_linear, 0.97f / peak);
    for (size_t i = 0; i < n; i++) slot[i] *= effective;

    int level;
    if (!is_playing) {
        level = -1;
    } else {
        float rel = rms_db - median_db;
        level = rel < -15.0f ? 0 : rel < -9.0f ? 1 : rel < -4.5f ? 2
              : rel < -1.5f ? 3 : rel < 1.5f ? 4 : rel < 4.5f ? 5
              : rel < 9.0f ? 6 : 7;
    }

    out->level = level;
    out->rms_db = rms_db;
    out->gain_db = lin_to_db(effective);
    out->session_median_db = median_db;
    out->noise_floor_db = noise_floor_db;
}

// Checkpoint/resume of the full reducer+AGC carried state (engine-level
// snapshots, audio_analyzer_rs_tpu/checkpoint.py).  Flat layout:
//   floats: hpf{x1,x2,y1,y2} lpf{x1,x2,y1,y2} envelope gain_linear
//           long_hist[256] play_hist[5000]                     = 5266
//   ints:   hold_remaining long_pos long_filled play_pos play_filled = 5
size_t reducer_state_floats(void) {
    return 10 + Reducer::LONG_LEN + Reducer::PLAY_LEN;
}
size_t reducer_state_ints(void) { return 5; }

void reducer_save_state(const Reducer* r, float* f, int32_t* i) {
    f[0] = r->hpf.x1; f[1] = r->hpf.x2; f[2] = r->hpf.y1; f[3] = r->hpf.y2;
    f[4] = r->lpf.x1; f[5] = r->lpf.x2; f[6] = r->lpf.y1; f[7] = r->lpf.y2;
    f[8] = r->envelope; f[9] = r->gain_linear;
    std::memcpy(f + 10, r->long_hist, sizeof r->long_hist);
    std::memcpy(f + 10 + Reducer::LONG_LEN, r->play_hist, sizeof r->play_hist);
    i[0] = r->hold_remaining;
    i[1] = r->long_pos; i[2] = r->long_filled ? 1 : 0;
    i[3] = r->play_pos; i[4] = r->play_filled ? 1 : 0;
}

void reducer_load_state(Reducer* r, const float* f, const int32_t* i) {
    r->hpf.x1 = f[0]; r->hpf.x2 = f[1]; r->hpf.y1 = f[2]; r->hpf.y2 = f[3];
    r->lpf.x1 = f[4]; r->lpf.x2 = f[5]; r->lpf.y1 = f[6]; r->lpf.y2 = f[7];
    r->envelope = f[8]; r->gain_linear = f[9];
    std::memcpy(r->long_hist, f + 10, sizeof r->long_hist);
    std::memcpy(r->play_hist, f + 10 + Reducer::LONG_LEN, sizeof r->play_hist);
    r->hold_remaining = i[0];
    r->long_pos = i[1]; r->long_filled = i[2] != 0;
    r->play_pos = i[3]; r->play_filled = i[4] != 0;
}

// ───────────────────────── Threaded pipeline ─────────────────────────────
// Reducer thread draining an input ring through conditioning into a
// consumer ring — the reference's thread topology (ref mod.rs:336-511)
// with the SlotPool refcount fan-out.

struct Pipeline {
    SlotPool* pool;
    Ring* free_ring;       // reclaimed slot indices
    Ring* input_ring;      // filled raw slots → reducer
    Ring* consumer_ring;   // conditioned slots → consumer
    Reducer* reducer;
    // Per-slot dynamics, written by the worker BEFORE the slot index is
    // published through consumer_ring (whose release/acquire pair orders
    // the write): each pulled slot carries its own conditioning snapshot,
    // and there is no cross-thread race on a shared struct.
    std::vector<DynamicsOut> slot_dyn;
    std::atomic<bool> running{true};
    std::thread worker;
};

static void pipeline_worker(Pipeline* p) {
    uint64_t idx;
    while (p->running.load(std::memory_order_relaxed)) {
        if (ring_pop(p->input_ring, &idx)) {
            DynamicsOut d;
            reducer_process(p->reducer, pool_slot_ptr(p->pool, idx),
                            p->pool->slot_len, &d);
            p->slot_dyn[idx] = d;
            pool_acquire(p->pool, idx, 1);
            if (!ring_push(p->consumer_ring, idx)) {
                if (pool_release(p->pool, idx) == 1)
                    ring_push(p->free_ring, idx);
            }
        } else {
            std::this_thread::yield();
        }
    }
}

Pipeline* pipeline_create(float sample_rate, size_t pool_size,
                          size_t slot_len) {
    Pipeline* p = new Pipeline();
    p->pool = pool_create(pool_size, slot_len);
    p->free_ring = ring_create(pool_size);
    p->input_ring = ring_create(pool_size);
    p->consumer_ring = ring_create(pool_size);
    p->reducer = reducer_create(sample_rate, slot_len);
    p->slot_dyn.resize(pool_size);
    for (size_t i = 0; i < pool_size; i++) ring_push(p->free_ring, i);
    p->worker = std::thread(pipeline_worker, p);
    return p;
}

void pipeline_destroy(Pipeline* p) {
    p->running.store(false);
    p->worker.join();
    reducer_destroy(p->reducer);
    ring_destroy(p->consumer_ring);
    ring_destroy(p->input_ring);
    ring_destroy(p->free_ring);
    pool_destroy(p->pool);
    delete p;
}

// Push one raw slot of audio; returns 1 on success, 0 if no free slot.
int pipeline_push_input(Pipeline* p, const float* data, size_t n) {
    uint64_t idx;
    if (!ring_pop(p->free_ring, &idx)) return 0;
    size_t len = std::min(n, p->pool->slot_len);
    std::memcpy(pool_slot_ptr(p->pool, idx), data, len * sizeof(float));
    if (len < p->pool->slot_len)
        std::memset(pool_slot_ptr(p->pool, idx) + len, 0,
                    (p->pool->slot_len - len) * sizeof(float));
    ring_push(p->input_ring, idx);
    return 1;
}

// Pull one conditioned slot (copies out + reclaims). Returns 1 on success.
int pipeline_pull_slot(Pipeline* p, float* out, DynamicsOut* dyn) {
    uint64_t idx;
    if (!ring_pop(p->consumer_ring, &idx)) return 0;
    std::memcpy(out, pool_slot_ptr(p->pool, idx),
                p->pool->slot_len * sizeof(float));
    *dyn = p->slot_dyn[idx];
    if (pool_release(p->pool, idx) == 1) ring_push(p->free_ring, idx);
    return 1;
}

size_t pipeline_pending(Pipeline* p) { return ring_len(p->consumer_ring); }

}  // extern "C"
