"""The port's daemon with ``--openlab`` (``shm_tpu_torch/serve_http.py``), on
the CPU over a real socket on 127.0.0.1: the scorer the parsed flags build
(``_load_scorer``) serves (N, 200, 4, 2) window pairs, and every ``/score``
reply (JSON and npz) equals ``score()`` called directly, mse and gate bit
for bit; a rank-3 body answers 400, another channel count 422,
``/score_series`` 422; ``/recalibrate`` and ``/reload`` on the openLAB
scorer; a ``--shadow`` of the other openLAB root; the concurrent batcher.
"""

import io
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.serve_http import _load_scorer, _parse_args, make_server
from torch_serve_models import err_code, metrics, octet, req, wait_for

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
OL = ROOT / "data" / "openlab"
TOKEN = "t0ken"


def _pairs(n, start=0):
    """n window pairs spread over the committed set (all of its classes)."""
    idx = np.linspace(start, 6431 - start, n).astype(int)
    Xc = np.load(OL / "extracted/X_clean.npy", mmap_mode="r")[idx]
    Xr = np.load(OL / "extracted/X_raw.npy", mmap_mode="r")[idx]
    return np.stack([Xc, Xr], axis=-1).astype(np.float32)


def _serve(argv, **kw):
    args, strides = _parse_args(argv)
    scorer = _load_scorer(args)
    shadow = None if args.shadow is None else _load_scorer(args, args.shadow)
    srv = make_server(scorer, port=0, series_strides=strides,
                      concurrent=args.concurrent, admin=args.admin,
                      admin_token=args.admin_token,
                      reload_fn=lambda: _load_scorer(args),
                      shadow_scorer=shadow, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    assert srv.warm_event.wait(timeout=300), "warmup never finished"
    assert srv.RequestHandlerClass.warm_error is None
    return srv, scorer, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.server_close()
    for part in (srv.batcher, srv.shadow):
        if part is not None:
            part.close()


@pytest.fixture(scope="module")
def daemon():
    srv, scorer, base = _serve(
        ["--openlab", str(OL), "--device", "cpu", "--min-bucket", "16",
         "--max-batch", "64", "--admin", "--admin-token", TOKEN,
         "--shadow", str(ROOT / "data/openlab_attention")])
    yield base, scorer, srv
    _stop(srv)


def _same(out, ref):
    np.testing.assert_array_equal(np.asarray(out["mse"], np.float32), ref["mse"])
    np.testing.assert_array_equal(np.asarray(out["anomalous"], bool),
                                  ref["anomalous"].astype(bool))
    np.testing.assert_array_equal(np.asarray(out["y_pred"]), ref["y_pred"])
    np.testing.assert_array_equal(np.asarray(out["p_struct"], np.float32),
                                  ref["p_struct"])


def test_score_replies_equal_score(daemon):
    base, scorer, _ = daemon
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    assert isinstance(scorer, OpenLabScorer) and scorer.device.type == "cpu"
    info = json.loads(req(base + "/info")[2])
    assert (info["seq_len"], info["num_features"]) == (200, 4)
    assert info["buckets"] == [16, 32, 64]
    X = _pairs(70)                        # a full 64 batch and a padded 16
    ref = scorer.score(X)
    assert ref["anomalous"].any() and not ref["anomalous"].all()
    _, ctype, body = req(base + "/score", data=X.tobytes(), headers=octet(X))
    assert ctype.startswith("application/json")
    _same(json.loads(body), ref)
    _, ctype, body = req(base + "/score", data=X.tobytes(),
                         headers=octet(X, Accept="application/octet-stream"))
    with np.load(io.BytesIO(body)) as z:
        _same({k: z[k] for k in z.files}, ref)
    _, _, body = req(base + "/score",
                     data=json.dumps({"windows": X[:3].tolist()}).encode(),
                     headers={"Content-Type": "application/json"})
    _same(json.loads(body), scorer.score(X[:3]))


def test_malformed_requests(daemon):
    base, _, _ = daemon
    rank3 = np.zeros((2, 200, 4), np.float32)
    assert err_code(base + "/score", data=rank3.tobytes(), headers=octet(rank3)) == 400
    bad = np.zeros((2, 200, 3, 2), np.float32)
    assert err_code(base + "/score", data=bad.tobytes(), headers=octet(bad)) == 422
    series = np.zeros((300, 4), np.float32)
    assert err_code(base + "/score_series", data=series.tobytes(),
                    headers=octet(series)) == 422


def test_shadow_recalibrate_and_reload(daemon):
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    base, scorer, srv = daemon
    auth = {"X-Admin-Token": TOKEN}
    # the earlier tests' requests drain first, then the counters restart
    wait_for(lambda: metrics(base)["shadow"]["pending_windows"] == 0,
             timeout=120, msg="shadow drain")
    req(base + "/shadow/reset", data=b"", headers=auth, method="POST")
    X = _pairs(40, start=3)
    req(base + "/score", data=X.tobytes(), headers=octet(X))
    wait_for(lambda: metrics(base)["shadow"]["windows"] >= 40, msg="shadow")
    snap = metrics(base)["shadow"]
    assert snap["windows"] == 40 and snap["dropped_windows"] == 0
    # the attention root's scorer, called directly, gives the counters
    cand = OpenLabScorer.from_artifacts(ROOT / "data/openlab_attention",
                                        device="cpu").score(X)
    prim = scorer.score(X)
    assert snap["gate_agree"] == int((cand["anomalous"] == prim["anomalous"]).sum())
    assert snap["pred_agree"] == int((cand["y_pred"] == prim["y_pred"]).sum())
    assert snap["shadow_anomalous"] == int(cand["anomalous"].sum())

    old = scorer.threshold
    healthy = _pairs(60, start=5)
    _, _, body = req(base + "/recalibrate", data=healthy.tobytes(),
                     headers=octet(healthy, **auth, **{"X-Percentile": "95"}))
    out = json.loads(body)
    from shm_tpu_torch.calibrate import percentile_threshold

    assert out["threshold"] == pytest.approx(
        percentile_threshold(scorer.score(healthy)["mse"], 95.0), rel=1e-6)
    assert srv.RequestHandlerClass.engine[0].threshold == out["threshold"]
    req(base + "/reload", data=b"", headers=auth, method="POST")
    wait_for(lambda: json.loads(req(base + "/reload", headers=auth)[2])["state"]
             in ("done", "failed"), timeout=120, msg="reload")
    assert json.loads(req(base + "/reload", headers=auth)[2])["state"] == "done"
    fresh = srv.RequestHandlerClass.engine[0]
    assert fresh is not scorer and fresh.threshold == old


def test_concurrent_daemon_answers_as_score():
    srv, scorer, base = _serve(["--openlab", str(OL), "--device", "cpu",
                                "--min-bucket", "16", "--max-batch", "64",
                                "--concurrent"])
    try:
        reqs = [_pairs(9, start=s) for s in range(4)]
        outs = [None] * 4

        def client(i):
            outs[i] = json.loads(req(base + "/score", data=reqs[i].tobytes(),
                                     headers=octet(reqs[i]))[2])

        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        for X, out in zip(reqs, outs):
            _same(out, scorer.score(X))
    finally:
        _stop(srv)
