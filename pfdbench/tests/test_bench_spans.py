"""The program's spans read from made-up traces (``pfdbench/spans.py``):
nested spans and their self time, the time outside every span, no reading
without markers or where they do not pair up, the host ms of ``pfd.hint``
over two requests, and ``capture_s`` on hand-filled capture and build
records."""

import importlib

import pytest

from pfdbench import run, spans, trace

READERS = ["seecoder_ms_per_img", "unet_ms_per_img", "controlnet_ms_per_img",
           "sampler_ms_per_img", "vae_decode_ms_per_img", "quantize_ms_per_img",
           "hint_ms_per_req"]


def _b(name):
    return f"pfd_span_begin_{name}"


def _e(name):
    return f"pfd_span_end_{name}"


# one request (us): an upload, SeeCoder, a step whose UNet holds a ControlNet
# call and a quantize pass, the VAE decode, the copy out
DEVICE = [("Memcpy HtoD", 0, 2),
          (_b("seecoder"), 2, 3), ("gemm", 3, 13), (_e("seecoder"), 13, 14),
          (_b("step"), 20, 21), ("cat", 21, 23),
          (_b("unet"), 23, 24), ("conv", 24, 34),
          (_b("controlnet"), 34, 35), ("conv", 35, 40), (_e("controlnet"), 40, 41),
          (_b("quantize"), 41, 42), ("round", 42, 44), (_e("quantize"), 44, 45),
          ("add", 45, 47), (_e("unet"), 47, 48),
          ("ddim", 48, 50), (_e("step"), 50, 51),
          (_b("vae_decode"), 51, 52), ("conv", 52, 72), (_e("vae_decode"), 72, 73),
          ("Memcpy DtoH", 80, 90)]
HOST = [("pfd.request", 0, 50), ("pfd.hint", 5, 15), ("pfdbench.request", 0, 50),
        ("pfd.request", 50, 100), ("pfd.hint", 55, 60), ("pfdbench.request", 50, 100)]


def _ctx(device, host=(), n_requests=1, n_images=2):
    tr = trace.Trace(sorted(device, key=lambda r: r[1]), list(host),
                     [(0.0, 100.0)] * n_requests, (0.0, 100.0))
    return run.TraceContext(tr, [], 0.0, n_requests, n_images)


def _read(name, ctx):
    return importlib.import_module(f"pfdbench.metrics.{name}").read(ctx)


def test_nested_spans_self_time():
    sp = spans.split(DEVICE)
    us = {k: round(v * 1e6, 6) for k, v in sp.self_s.items()}
    assert us == {"seecoder": 12, "step": 6, "unet": 14, "controlnet": 7, "quantize": 4,
                  "vae_decode": 22}
    assert sp.counts == dict.fromkeys(us, 1)
    ctx = _ctx(DEVICE)
    for name, span in [("seecoder", "seecoder"), ("unet", "unet"), ("controlnet", "controlnet"),
                       ("sampler", "step"), ("vae_decode", "vae_decode"),
                       ("quantize", "quantize")]:
        assert _read(f"{name}_ms_per_img", ctx) == pytest.approx(us[span] / 1e3 / 2)


def test_outside_time_and_the_whole():
    sp = spans.split(DEVICE + [("pfd.replay", 20, 51)])  # a host span's copy: no device work
    assert sp.outside_s == pytest.approx(12e-6)  # the two copies
    assert sp.total_s == pytest.approx(77e-6)
    assert sum(sp.self_s.values()) + sp.outside_s == pytest.approx(sp.total_s)
    assert _ctx(DEVICE).trace.busy_s() == pytest.approx(sp.total_s)


def test_no_markers_no_reading():
    plain = [(n, s, e) for n, s, e in DEVICE if not n.startswith("pfd_span_")]
    assert spans.split(plain) is None
    ctx = _ctx(plain, HOST, n_requests=2)
    assert [_read(name, ctx) for name in READERS] == [None] * len(READERS)


@pytest.mark.parametrize("fault", ["an end missing", "an end without its begin",
                                   "ends out of order"])
def test_unbalanced_markers_no_reading(fault):
    dev = list(DEVICE)
    if fault == "an end missing":
        dev.remove((_e("unet"), 47, 48))
    elif fault == "an end without its begin":
        dev.remove((_b("vae_decode"), 51, 52))
    else:
        i, j = dev.index((_e("controlnet"), 40, 41)), dev.index((_e("unet"), 47, 48))
        dev[i], dev[j] = (_e("unet"), 40, 41), (_e("controlnet"), 47, 48)
    assert spans.split(dev) is None
    ctx = _ctx(dev, HOST, n_requests=2)
    assert [_read(name, ctx) for name in READERS] == [None] * len(READERS)


def test_hint_ms_per_req_over_two_requests():
    ctx = _ctx(DEVICE, HOST, n_requests=2)
    assert _read("hint_ms_per_req", ctx) == pytest.approx((10 + 5) / 1e3 / 2)
    assert _read("hint_ms_per_req", _ctx(DEVICE, [("pfd.request", 0, 50)])) is None


def test_capture_s_takes_out_the_builds(monkeypatch):
    from pfd_tpu_torch.ops import cuda_build, graphs

    captures = [{"warmup_s": 3.0, "capture_s": 1.0, "launches": {}, "t": 1000.0},
                {"warmup_s": 0.5, "capture_s": 0.25, "launches": {}, "t": 1001.0}]
    # one build inside the first capture's warm-up, one long before
    builds = [{"t": 998.0, "seconds": 2.0, "names": ["span_mark"]},
              {"t": 900.0, "seconds": 5.0, "names": ["conv_int8"]}]
    monkeypatch.setattr(graphs, "CAPTURES", captures)
    monkeypatch.setattr(cuda_build, "BUILDS", builds)
    assert _read("capture_s", _ctx(DEVICE, HOST)) == pytest.approx(4.0 + 0.75 - 2.0)
    # the second made inside the traced requests: left out
    late = _ctx(DEVICE, HOST + [("pfd.capture", 60, 70)])
    assert _read("capture_s", late) == pytest.approx(4.0 - 2.0)
    monkeypatch.setattr(graphs, "CAPTURES", [])
    assert _read("capture_s", _ctx(DEVICE, HOST)) is None
