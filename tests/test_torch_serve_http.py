"""The port's HTTP front end (``pfd_tpu_torch/serve.py``), as
``tests/test_serve_http.py`` drives ``pfd_tpu``'s: health and zoo
metadata, the inference round trip with both image codecs, the error and
404 paths, on a stub pipeline; then one round trip through a tiny real
pipeline on the CPU, with a hint, held against the same request made
directly; the CLI's flags against ``pfd_tpu``'s.
"""

import ast
import os
import sys
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from pfd_tpu_torch import serve, zoo
from pfd_tpu_torch.ops import flash_attention as fa
from pfd_tpu_torch.pipeline import PromptFreeDiffusionPipeline
from tests.test_pipeline_hotswap import TINY_PFD
from tests.test_serve_http import _StubPipeline, _get, _post

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _server(pipeline):
    serve._Handler.pipeline = pipeline
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve._Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def server():
    stub = _StubPipeline()
    srv, base = _server(stub)
    try:
        yield base, stub
    finally:
        srv.shutdown()
        srv.server_close()


def test_health_reports_tags_and_zoo(server):
    base, _ = server
    status, body = _get(base + "/health")
    assert status == 200 and body["status"] == "ok"
    assert body["tags"] == {"ctx": "SeeCoder", "diffuser": "Deliberate-v2.0", "ctl": "canny"}
    assert body["zoo"] == {"diffusers": list(zoo.DIFFUSER_PATH), "ctx": list(zoo.CTXENCODER_PATH),
                           "controlnets": list(zoo.CONTROLNET_PATH),
                           "preprocess": zoo.PREPROCESS_METHODS}


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_path_404(server, method):
    base, _ = server
    status, _ = _get(base + "/nope") if method == "GET" else _post(base + "/nope", {})
    assert status == 404


def test_inference_roundtrip_list_payload(server):
    base, stub = server
    im = np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    status, body = _post(base + "/inference", {"image": im.tolist(), "h": 128, "w": 192,
                                               "ugscale": 3.5, "seed": 7, "steps": 5})
    assert status == 200
    assert stub.calls[-1] == dict(ctl_method="canny", h=128, w=192, ugscale=3.5, seed=7,
                                  steps=5, has_ctl=False)
    out, hint = serve._decode_image(body["image"]), serve._decode_image(body["hint"])
    assert out.shape == (2, 3, 3) and hint.shape == (2, 3, 3)
    np.testing.assert_allclose(out, 127 / 255, atol=1 / 255)
    assert float(hint.max()) == 0.0


def test_inference_control_image_forwarded(server):
    base, stub = server
    im = np.zeros((8, 8, 3), np.float32)
    status, _ = _post(base + "/inference", {"image": im.tolist(), "control_image": im.tolist()})
    assert status == 200 and stub.calls[-1]["has_ctl"] is True


def test_inference_missing_image_is_500_with_error(server):
    base, _ = server
    status, body = _post(base + "/inference", {"h": 512})
    assert status == 500 and "KeyError" in body["error"]


def test_image_codec_roundtrip_with_and_without_pil(monkeypatch):
    """_encode_image -> _decode_image keeps floor(x * 255) / 255 with PIL
    (base64 PNG) and without it (nested uint8 lists, the card's host's
    path), where base64 input raises."""
    rng = np.random.default_rng(0)
    img = rng.random((5, 7, 3)).astype(np.float32)
    want = np.floor(img * 255)
    enc = serve._encode_image(img)
    assert isinstance(enc, str)
    np.testing.assert_allclose(serve._decode_image(enc) * 255, want, atol=0.5)
    monkeypatch.setitem(sys.modules, "PIL", None)
    lists = serve._encode_image(img)
    assert isinstance(lists, list)
    np.testing.assert_array_equal(serve._decode_image(lists), want)
    with pytest.raises(ValueError, match="PIL"):
        serve._decode_image(enc)


def test_gradio_absent_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio"):
        serve.serve_gradio(_StubPipeline())


def _flags(actions):
    return {a.option_strings[0]: (a.default, type(a).__name__, getattr(a, "type", None).__name__
                                  if getattr(a, "type", None) else None,
                                  tuple(a.choices) if a.choices else None)
            for a in actions if a.option_strings and a.dest != "help"}


def test_cli_flags_match_pfd_tpu():
    """The port's CLI has pfd_tpu's flags, with their kinds, types, choices
    and defaults, and no others (pfd_tpu/serve.py's ``add_argument`` calls)."""
    import argparse

    tree = ast.parse(open(os.path.join(REPO, "pfd_tpu", "serve.py")).read())
    ref = argparse.ArgumentParser()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: (ast.literal_eval(k.value) if k.arg != "type"
                          else {"int": int, "float": float}[k.value.id]) for k in node.keywords}
            ref.add_argument(*[a.value for a in node.args], **kw)
    assert _flags(serve.build_parser()._actions) == _flags(ref._actions)


def test_cli_builds_the_pipeline_from_the_flags(monkeypatch):
    got = {}
    monkeypatch.setattr(serve, "PromptFreeDiffusionPipeline", lambda **kw: got.update(kw) or kw)
    monkeypatch.setattr(serve, "serve_http", lambda pipe, port: got.update(port=port))
    serve.main(["--int8", "--phases", "8x2,42x21", "--kv-pool", "2", "--port", "8080"])
    assert got["quantized"] is True and got["self_attn_fn"] is fa.self_attn_fn
    assert got["phases"] == [(8, 2), (42, 21)] and got["kv_pool"] == 2 and got["port"] == 8080
    serve.main([])
    assert got["quantized"] is False and got["phases"] is None and got["port"] == 11234


def test_round_trip_through_a_tiny_pipeline(tmp_path):
    """A real request over HTTP (nested-list payloads, a canny hint, 2 steps)
    gives the 8-bit image and hint of the same request made directly."""
    pipe = PromptFreeDiffusionPipeline(fp16=False, config_override=TINY_PFD, device="cpu",
                                       pretrained_root=str(tmp_path))
    rng = np.random.default_rng(5)
    ref = rng.random((64, 64, 3), dtype=np.float32)
    hint = np.zeros((64, 64, 3), np.float32)
    hint[16:48, 20:44] = 1.0
    srv, base = _server(pipe)
    try:
        status, body = _post(base + "/inference", {
            "image": ref.tolist(), "control_image": hint.tolist(), "h": 64, "w": 64,
            "seed": 5, "steps": 2})
        status_h, health = _get(base + "/health")
    finally:
        srv.shutdown()
        srv.server_close()
    assert status == 200, body
    assert status_h == 200 and health["tags"]["diffuser"] == "Deliberate-v2.0"
    img, hnt = pipe.action_inference(ref, hint, "canny", True, 64, 64, 2.0, 5, steps=2)
    for key, want in (("image", img), ("hint", hnt)):
        got = np.asarray(serve._decode_image(body[key]))
        np.testing.assert_array_equal(np.round(got * 255), np.floor(np.clip(want, 0, 1) * 255))
    assert hnt.any() and np.isfinite(img).all()
