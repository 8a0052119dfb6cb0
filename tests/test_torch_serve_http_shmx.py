"""The port's daemon (``shm_tpu_torch/serve_http.py``) serving ``.shmx``
exports (``shm_tpu_torch/export.py``) on the CPU, as the JAX daemon's
``--shmx`` and ``.shmx`` ``--shadow`` do: the flags' parsing (``--shmx``
leaves the bucket policy to the artifact; ``--openlab`` beside ``--shmx``
and ``--devices 2`` refused), ``/info`` reporting ``exported: true``,
``/score`` equal to ``ExportedScorer.score``, ``/recalibrate`` refused
with 501, ``/reload`` of the artifact, and a ``.shmx`` shadow whose
agreement counters reach ``/metrics``. The models are
``tests/torch_serve_models.py``'s (T=20, D=4).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from shm_tpu_torch.export import load_exported_scorer, save_exported_scorer
from shm_tpu_torch.serve_http import (
    _load_scorer, _load_shadow_scorer, _parse_args, make_server,
)
from torch_serve_models import (
    T, D, err_code, metrics, octet, port_scorer, req, wait_for, windows,
)

torch.set_num_threads(1)
TOKEN = "shmx-admin"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(primary .shmx, shadow .shmx: the same model at another threshold)."""
    tmp = tmp_path_factory.mktemp("shmx")
    a = save_exported_scorer(port_scorer(min_bucket=16, max_batch=32), tmp / "a.shmx")
    b = save_exported_scorer(port_scorer(threshold=0.5, min_bucket=16, max_batch=32),
                             tmp / "b.shmx")
    return a, b


def test_parse_args_shmx_bucket_policy():
    """--shmx leaves the bucket policy unset, so the artifact's recorded
    min_bucket / max_batch apply; in-process scorers get 256 / 8192."""
    args, strides = _parse_args(["--shmx", "gate.shmx"])
    assert args.min_bucket is None and args.max_batch is None
    assert strides == (1,)
    args, _ = _parse_args(["--shmx", "gate.shmx", "--min-bucket", "64"])
    assert args.min_bucket == 64 and args.max_batch is None
    args, _ = _parse_args(["--shadow", "gate.shmx"])
    assert (args.min_bucket, args.max_batch) == (256, 8192)
    args, _ = _parse_args([])
    assert (args.min_bucket, args.max_batch) == (256, 8192)


@pytest.mark.parametrize("argv, msg", [
    (["--shmx", "a.shmx", "--openlab", "data/openlab"], "mutually exclusive"),
    (["--shmx", "a.shmx", "--devices", "2"], "does not apply to --shmx"),
    (["--shmx", "a.shmx", "--series-strides", "0"], "series-strides"),
])
def test_parse_args_shmx_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as ei:
        _parse_args(argv)
    assert ei.value.code == 2 and msg in capsys.readouterr().err


def test_load_scorer_reads_the_artifact(artifacts):
    a, b = artifacts
    args, _ = _parse_args(["--shmx", str(a), "--device", "cpu", "--shadow", str(b)])
    primary, shadow = _load_scorer(args), _load_shadow_scorer(args)
    assert primary.exported and list(primary.buckets()) == [16, 32]
    assert shadow.exported and list(shadow.buckets())[0] == 256   # concrete
    assert shadow.threshold == 0.5
    args, _ = _parse_args(["--shmx", str(a), "--device", "cpu",
                           "--min-bucket", "32"])
    assert list(_load_scorer(args).buckets()) == [32]


@pytest.fixture(scope="module")
def server(artifacts):
    a, b = artifacts
    args, strides = _parse_args(["--shmx", str(a), "--device", "cpu", "--admin",
                                 "--admin-token", TOKEN])
    shadow = load_exported_scorer(b, device="cpu", min_bucket=16, max_batch=32)
    srv = make_server(_load_scorer(args), port=0, series_strides=strides,
                      admin=True, admin_token=TOKEN,
                      reload_fn=lambda: _load_scorer(args), shadow_scorer=shadow)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    assert srv.warm_event.wait(timeout=120)
    assert srv.RequestHandlerClass.warm_error is None
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    srv.shadow.close()


def test_info_reports_an_exported_program(server):
    _, base = server
    info = json.loads(req(base + "/info")[2])
    assert info["exported"] is True and info["use_fused_vae"] is False
    assert info["buckets"] == [16, 32] and info["device"] == "cpu"
    assert info["seq_len"] == T and info["num_features"] == D


def test_score_equals_the_exported_scorer(server, artifacts):
    _, base = server
    direct = load_exported_scorer(artifacts[0], device="cpu")
    W = windows(45, seed=11)
    out = json.loads(req(base + "/score", data=W.tobytes(), headers=octet(W))[2])
    ref = direct.score(W)
    np.testing.assert_array_equal(np.float32(out["mse"]), ref["mse"])
    np.testing.assert_array_equal(np.float32(out["p_struct"]), ref["p_struct"])
    assert out["y_pred"] == [int(v) for v in ref["y_pred"]]
    assert out["anomalous"] == [bool(v) for v in ref["anomalous"]]


def test_recalibrate_is_refused_for_an_exported_program(server):
    _, base = server
    W = windows(16, seed=12)
    code = err_code(base + "/recalibrate", data=W.tobytes(),
                    headers=octet(W, **{"X-Admin-Token": TOKEN}), method="POST")
    assert code == 501


def settled_shadow(base: str, pause: float = 0.1) -> dict:
    """The shadow's counters once it has scored every window posted so far:
    nothing pending and the window count unchanged across two reads
    ``pause`` apart (a reply precedes its shadow copy's enqueue, so one read
    of an empty queue is not enough)."""
    last = [None]

    def settled() -> bool:
        snap = metrics(base)["shadow"]
        ok = (snap["pending_windows"] == 0 and last[0] is not None
              and snap["windows"] == last[0]["windows"])
        last[0] = snap
        if not ok:
            time.sleep(pause)
        return ok

    wait_for(settled, msg="the shadow to score the earlier requests")
    return last[0]


def test_shmx_shadow_counts_agreement_on_metrics(server, artifacts):
    """Every /score request is scored again by the .shmx shadow; its
    counters are what the two exported scorers give directly. ``before`` is
    read once the shadow has scored the earlier tests' requests."""
    srv, base = server
    before = settled_shadow(base)
    W = windows(24, seed=13)
    req(base + "/score", data=W.tobytes(), headers=octet(W))
    wait_for(lambda: metrics(base)["shadow"]["windows"] >= before["windows"] + 24,
             msg="the shadow's windows")
    snap = metrics(base)["shadow"]
    a = load_exported_scorer(artifacts[0], device="cpu").score(W)
    b = load_exported_scorer(artifacts[1], device="cpu").score(W)
    assert snap["gate_agree"] - before["gate_agree"] == int(
        (a["anomalous"] == b["anomalous"]).sum())
    assert snap["pred_agree"] - before["pred_agree"] == int(
        (a["y_pred"] == b["y_pred"]).sum())
    assert snap["gate_agree"] - before["gate_agree"] < 24     # thresholds differ
    text = req(base + "/metrics")[2].decode()
    assert "shm_shadow_windows_total" in text and "shm_shadow_warmed 1" in text


def test_reload_rebuilds_from_the_artifact(server):
    _, base = server
    tok = {"X-Admin-Token": TOKEN}
    req(base + "/reload", data=b"", headers=tok, method="POST")
    wait_for(lambda: json.loads(req(base + "/reload", headers=tok)[2])["state"]
             in ("done", "failed"), timeout=120, msg="the reload")
    assert json.loads(req(base + "/reload", headers=tok)[2])["state"] == "done"
    assert json.loads(req(base + "/info")[2])["exported"] is True
