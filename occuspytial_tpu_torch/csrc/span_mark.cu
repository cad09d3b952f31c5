// One-thread marker kernel of the port's phase spans (tracing.py).
//
// Replaces no TPU kernel: the JAX package traces a step on the host
// around its compiled program. Here a Gibbs step is one CUDA graph
// replay, which runs no host code, so a phase's begin and end are marks
// launched inside the step: each is one thread that reads the card's
// nanosecond clock (%globaltimer) and updates a small int64 accumulator
// in device memory. A graph captured with marks binds the accumulator's
// address, so every replay accumulates there, and the host reads it at a
// synchronisation. Marks of one stream run in order, one after the
// kernel before it, so plain loads and stores are enough.
//
// Accumulator layout (int64, tracing.py reads the same offsets):
//   [0] first stamp since the last reset (0: none yet)
//   [1] last stamp
//   [2] end stamp of the last `step` phase (0: none since the reset)
//   [3] launch_gap sum, [4] its count: a step's end to the next step's
//       begin inside one chunk of a run
//   [5] block_boundary sum, [6] its count: a chunk's last step end to the
//       next chunk's first step begin
//   [8 + p], [8 + P + p], [8 + 2 P + p]: phase p's open stamp, its summed
//       time and its count; phase 0 is `step`.
//
// What bounds it on the card: the launch itself (about a microsecond in
// a graph); one thread does a few loads and stores.

#include <cuda_runtime.h>

namespace {

constexpr int kHeader = 8;

__global__ void span_mark_kernel(long long* acc, int phases, int close,
                                 int open, const long long* slot,
                                 int first) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    const long long t = (long long)now;
    long long* begin = acc + kHeader;
    long long* sum = begin + phases;
    long long* count = sum + phases;
    if (acc[0] == 0) acc[0] = t;
    acc[1] = t;
    if (close >= 0) {
        sum[close] += t - begin[close];
        count[close] += 1;
        if (close == 0) acc[2] = t;
    }
    if (open >= 0) {
        begin[open] = t;
        if (open == 0 && acc[2] != 0) {
            // the step's first in its chunk: the graph's slot counter is 0
            // before the first replay of a chunk stores its draws
            const bool head = first < 0 ? *slot == 0 : first != 0;
            acc[head ? 5 : 3] += t - acc[2];
            acc[head ? 6 : 4] += 1;
        }
    }
}

}  // namespace

// `acc` the accumulator of `phases` phases (device int64); `close` and
// `open` phase indices or -1 (one mark may close one phase and open
// another); `slot` the device int64 slot counter of a captured step,
// read when `first` is -1, else `first` says whether a `step` opened here
// is its chunk's first. Returns a CUDA error code (0 on success).
extern "C" int span_mark_launch(void* acc, int phases, int close, int open,
                                const void* slot, int first, void* stream) {
    span_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long*)acc, phases, close, open, (const long long*)slot, first);
    return (int)cudaGetLastError();
}

extern "C" const char* span_mark_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
