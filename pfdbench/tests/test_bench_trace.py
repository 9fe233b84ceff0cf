"""Reading a trace: the kernels told apart by name, busy time and idle gaps,
the profiler's copies of user annotations left out, and the per-layer
readers on a made-up trace (a roofline share, and none where the launches
are not the expected ones; the training cell's exposed NCCL time and FP32
share of peak)."""

from types import SimpleNamespace

from pfdbench import metrics, run, trace, work

K1 = "void pfd::sm90::flash_sm90_kernel<1, 2, false, false, 1, false, false>(CUtensorMap)"
K2 = "void pfd::sm90::flash_sm90_kernel<1, 2, false, true, 2, false, false>(CUtensorMap)"
K4 = "void pfd::sm90::flash_sm90_kernel<1, 2, false, false, 1, true, false>(CUtensorMap)"
K5 = "void pfd::sm90::flash_sm90_kernel<1, 2, false, false, 1, true, true>(CUtensorMap)"


def test_kernel_classes():
    assert trace.kernel_class(K1) == "flash_attention"
    assert trace.kernel_class(K2) == "cross_attention"
    assert trace.kernel_class(K2.replace("true, 2", "false, 2")) == "cross_attention"
    assert trace.kernel_class(K4) == "flash_attention_pv8"
    assert trace.kernel_class(K5) == "flash_attention_int8"
    assert trace.kernel_class(K1.replace("2, false, false, 1", "2, true, false, 1")) == \
        "flash_attention_pipe"
    mangled = "_ZN3pfd4sm9017flash_sm90_kernelILi1ELi2ELb0ELb1ELi2ELb0ELb0EEEv14CUtensorMap_st"
    assert trace.kernel_class(mangled) == "cross_attention"
    assert trace.kernel_class("void conv_int8_kernel<160>(CUtensorMap)") == "conv_int8"
    assert trace.kernel_class("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>(x)") == "layout"
    assert trace.kernel_class("void cudnn::ops::nhwcToNchwKernel<float>(x)") == "layout"
    assert trace.kernel_class("ampere_bf16_s16816gemm_bf16_128x128") is None


def _trace():
    dev = [(K1, 10.0, 20.0), (K1, 15.0, 25.0), (K2, 40.0, 45.0), ("gemm", 60.0, 70.0)]
    host = [("pfdbench.request", 0.0, 50.0), ("cudaGraphLaunch", 26.0, 39.0),
            ("pfdbench.request", 50.0, 100.0)]
    return trace.Trace(dev, host, [(0.0, 50.0), (50.0, 100.0)], (0.0, 100.0))


def test_busy_and_idle():
    t = _trace()
    assert t.busy() == [[10.0, 25.0], [40.0, 45.0], [60.0, 70.0]]
    assert abs(t.busy_s() - 30e-6) < 1e-12 and abs(t.window_s - 100e-6) < 1e-12
    assert t.idle_gaps() == [(0.0, 10.0), (25.0, 40.0), (45.0, 60.0), (70.0, 100.0)]
    assert t.by_class() == {"flash_attention": (20e-6, 2), "cross_attention": (5e-6, 1)}
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["request", 30e-6]
    assert b["idle_gaps"][1][0] == "request/cudaGraphLaunch"
    assert b["device_ops"][0][0] == K1


def test_readers():
    t = _trace()
    calls = [work.Call("flash_attention", (), 989e12 * 4e-6, 0, 0),
             work.Call("cross_attention", (), 0, 0, 3.35e12 * 1e-6)]
    ctx = run.TraceContext(t, calls, 989e12 * 10e-6, 2, 2)
    # 2 requests x 1 call expected, 2 traced: 2 x 4 us bound in 20 us
    assert abs(metrics.roofline(ctx, "flash_attention") - 40.0) < 1e-9
    # 2 expected, 1 traced: no share
    assert metrics.roofline(ctx, "cross_attention") is None
    assert metrics.roofline(ctx, "conv_int8") is None
    assert abs(metrics.share_of_peak(ctx) - 20.0) < 1e-9
    from pfdbench.metrics import idle_ms_per_req, idle_share
    assert abs(idle_share.read(ctx) - 70.0) < 1e-9
    assert abs(idle_ms_per_req.read(ctx) - (35e-3 + 35e-3) / 2) < 1e-12


def _event(name, start, end, device, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=SimpleNamespace(name=device),
                           is_user_annotation=annotation)


def test_annotation_copies_are_no_device_work():
    prof = SimpleNamespace(events=lambda: [
        _event("pfdbench.request", 0.0, 100.0, "CPU", True),
        _event("pfdbench.request", 0.0, 100.0, "CUDA", True),
        _event("Optimizer.step#AdamW.step", 10.0, 90.0, "CUDA", True),
        _event("nccl:all_reduce", 40.0, 60.0, "CUDA", True),
        _event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 41.0, 59.0, "CUDA"),
        _event(K1, 10.0, 20.0, "CUDA")])
    t = trace.from_profiler(prof, [], (0.0, 100.0))
    assert [n for n, _, _ in t.device] == [K1, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"]
    assert [n for n, _, _ in t.host] == ["pfdbench.request"]
    assert abs(t.busy_s() - 28e-6) < 1e-12


def test_training_readers():
    from pfdbench.metrics import allreduce_exposed_ms_per_step, mfu_fp32
    dev = [("ncclDevKernel_AllReduce", 100.0, 200.0), ("gemm", 150.0, 170.0),
           ("ncclDevKernel_AllGather", 190.0, 260.0), ("gemm", 250.0, 300.0),
           ("ncclDevKernel_AllGather", 400.0, 410.0)]
    t = trace.Trace(dev, [], [(0.0, 500.0), (500.0, 1000.0)], (0.0, 1000.0))
    ctx = run.TraceContext(t, [], work.PEAK_FP32 * 100e-6, 2, 16)
    # NCCL over 100-260 and 400-410, other kernels over 150-170 and 250-300:
    # 50 + 80 + 0 + 10 us bare, over 2 steps
    assert abs(allreduce_exposed_ms_per_step.read(ctx) - 70e-3) < 1e-12
    assert abs(mfu_fp32.read(ctx) - 20.0) < 1e-9
    bare = trace.Trace(dev[1:2], [], [(0.0, 1000.0)], (0.0, 1000.0))
    assert allreduce_exposed_ms_per_step.read(run.TraceContext(bare, [], 1.0, 1, 8)) is None
