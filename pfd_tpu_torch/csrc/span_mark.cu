// The device side of the program's spans (utils/profiling.py): one empty
// kernel of one thread at a layer's start and one at its end, launched on the
// stream that runs the layer's work, named pfd_span_begin_<name> and
// pfd_span_end_<name> (extern "C", so the profiler shows the names as they
// are). A launch made while a CUDA graph is captured becomes a node of the
// graph, so the markers bracket the layer's kernels in every replay.
//
// Replaces no TPU kernel: added so that the kernels of a replayed graph can be
// split by layer. Bound by launch latency alone (an empty node of a graph);
// nothing is read or written.
//
// The names come from profiling.DEVICE_SPANS, which ops/cuda_build.py passes
// as -DPFD_DEVICE_SPANS=X(seecoder)X(step)...: one entry a layer, in the
// table's order, which is the index pfd_span_mark takes.

#include <cuda_runtime.h>

#ifndef PFD_DEVICE_SPANS
#error "PFD_DEVICE_SPANS is not defined: build through ops/cuda_build.py"
#endif

#define X(name)                                              \
  extern "C" __global__ void pfd_span_begin_##name() {}      \
  extern "C" __global__ void pfd_span_end_##name() {}
PFD_DEVICE_SPANS
#undef X

namespace {

typedef void (*Marker)();

#define X(name) {pfd_span_begin_##name, pfd_span_end_##name},
const Marker kMarkers[][2] = {PFD_DEVICE_SPANS};
#undef X

const int kSpans = (int)(sizeof(kMarkers) / sizeof(kMarkers[0]));

}  // namespace

// Launches the begin (end == 0) or end (end == 1) marker of span `index` on
// `stream`. Returns a cudaError_t.
extern "C" int pfd_span_mark(int index, int end, void* stream) {
  if (index < 0 || index >= kSpans || (end != 0 && end != 1))
    return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel((const void*)kMarkers[index][end], dim3(1), dim3(1), nullptr, 0,
                               static_cast<cudaStream_t>(stream));
}
