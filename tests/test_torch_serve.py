"""The port's JSON API (``mdx_torch.serve``: api, executor, wsgi, config)
and run-scoped chat (``mdx_torch.pipeline.chat``, ``mdx_torch.genai.client``)
against the JAX package's (``mdx.serve``, ``mdx.pipeline.chat``,
``mdx.genai.client``), on the CPU.

* Every case of ``tests/test_serve.py`` runs on both packages (the
  ``client`` fixture is parametrised on the package; the port's app on
  ``device="cpu"``), in-process through the WSGI callable, runs through
  each package's real executor.
* The same upload through both servers: the same status codes and JSON
  bodies (the index's ``name`` aside; ids, paths and the numbers of the
  report masked), and DB rows held to each other by
  ``parity.compare_rows``.
* Four runs posted back to back to the port's server (its four workers
  run them at once): each row equal, field for field, to a serial
  ``run_pipeline`` of the same file.
* ``{"genai": true}`` and ``{"genai": true, "autotune": true}`` on both
  servers: the model call fails (no key; a transport that raises, so no
  test reaches a network) and both fall back to their deterministic runs;
  with ``autotune`` both sweep.  ``{"genai": true, "max_iters": 2}`` with
  a scripted model in each package: the GenAI run on a worker thread
  (two plans applied, validated and scored), the rows equal.
* ``tests/test_spa_contract.py``'s route check against the port's app.
* ``tests/test_genai.py``'s three chat cases and its client cases (the
  scripted transport, JSON extraction, the stdlib HTTP transport against a
  local server) on both packages.
* Without a card, ``create_app()`` raises with ``resolve_device``'s
  message.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import time

import pytest
import torch

from test_serve import _Client, _synthetic_dcm
from test_spa_contract import _client_paths

from mdx.genai import client as JL
from mdx.pipeline import chat as JC
from mdx.pipeline import storage as JST

from mdx_torch import parity
from mdx_torch.genai import client as PL
from mdx_torch.pipeline import chat as PC
from mdx_torch.pipeline import storage as PST
from mdx_torch.pipeline.runner import run_pipeline

torch.set_num_threads(1)

PKGS = ("jax", "port")
STORAGE = {"jax": JST, "port": PST}
CHAT = {"jax": JC, "port": PC}
LLM = {"jax": JL, "port": PL}
SIZE = 64


def _app(pkg: str):
    """A fresh app of ``pkg`` on the environment's paths."""
    if pkg == "jax":
        from mdx.serve import api, config
    else:
        from mdx_torch.serve import api, config
    importlib.reload(config)
    importlib.reload(api)
    return api.create_app() if pkg == "jax" else api.create_app(device="cpu")


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "mdx.db"))
    monkeypatch.setenv("UPLOAD_DIR", str(tmp_path / "uploads"))
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "outputs"))
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    return tmp_path


@pytest.fixture(params=PKGS)
def client(request, env):
    client = _Client(_app(request.param))
    client.pkg = request.param
    return client


@pytest.fixture()
def both(env):
    return {pkg: _Client(_app(pkg)) for pkg in PKGS}


@pytest.fixture()
def model_down(monkeypatch):
    """Both packages' model calls fail, as without a key or a network."""
    def down(model, payload):
        raise JL.LLMError("model call refused by the test")

    for llm in LLM.values():
        monkeypatch.setattr(llm, "_transport", down)


def _wait(client, run_id: str, limit: float = 120.0) -> str:
    deadline = time.time() + limit
    status = "pending"
    while time.time() < deadline:
        s, st = client.get_json(f"/api/runs/{run_id}/status")
        assert s == 200
        status = st["status"]
        if status in ("completed", "error"):
            break
        time.sleep(0.2)
    return status


def _upload_run(client, content: bytes, name: str, **body):
    s, up = client.upload("/api/upload", "file", name, content)
    assert s == 200, up
    s, run = client.post_json("/api/run", {"file_id": up["file_id"], **body})
    assert s == 202 and run["status"] == "pending", run
    return up, run["run_id"]


# ------------------------------------------------ tests/test_serve.py cases


class TestRoutes:
    def test_index(self, client):
        s, data = client.get_json("/")
        assert s == 200
        assert data["status"] == "running"
        assert "upload" in data["endpoints"]

    def test_404(self, client):
        s, data = client.get_json("/api/nope")
        assert s == 404

    def test_upload_no_file(self, client):
        s, data = client.post_json("/api/upload", {})
        assert s == 400

    def test_upload_bad_extension(self, client, tmp_path):
        s, data = client.upload("/api/upload", "file", "evil.exe", b"xx")
        assert s == 400
        assert "Unsupported" in data["error"]

    def test_upload_ok(self, client, tmp_path):
        content = _synthetic_dcm(tmp_path)
        s, data = client.upload("/api/upload", "file", "scan.dcm", content)
        assert s == 200
        assert len(data["file_id"]) == 12
        assert data["stored_name"].endswith("scan.dcm")

    def test_run_requires_file_id(self, client):
        s, data = client.post_json("/api/run", {})
        assert s == 400

    def test_run_unknown_file(self, client):
        s, data = client.post_json("/api/run", {"file_id": "nope"})
        assert s == 404

    def test_runs_list_empty(self, client):
        s, data = client.get_json("/api/runs")
        assert s == 200 and data["runs"] == []

    def test_run_detail_404(self, client):
        s, _ = client.get_json("/api/runs/deadbeef")
        assert s == 404

    def test_status_404(self, client):
        s, _ = client.get_json("/api/runs/deadbeef/status")
        assert s == 404

    def test_chat_validation(self, client):
        s, _ = client.post_json("/api/runs/x/chat", {})
        assert s == 400
        s, _ = client.post_json("/api/runs/x/chat", {"message": "y" * 2001})
        assert s == 400

    def test_file_serving_traversal_blocked(self, client):
        s, _, _ = client.request("GET", "/api/files/outputs/../secrets")
        assert s == 404


class TestEndToEndRun:
    def test_upload_run_poll_report(self, client, tmp_path):
        content = _synthetic_dcm(tmp_path, "noisy")
        _, run_id = _upload_run(client, content, "noisy.dcm")
        assert _wait(client, run_id) == "completed"

        s, detail = client.get_json(f"/api/runs/{run_id}")
        assert s == 200
        assert detail["run_id"] == run_id
        assert "noise" in detail["issues"]
        assert detail["chat_history"] == []

        s, rep = client.get_json(f"/api/runs/{run_id}/report")
        assert s == 200 and rep["markdown"]

        s, logs = client.get_json(f"/api/runs/{run_id}/logs")
        assert s == 200

        s, lst = client.get_json("/api/runs")
        assert any(r["run_id"] == run_id for r in lst["runs"])


class TestErrorPaths:
    def test_corrupt_dicom_run_errors(self, client, tmp_path):
        _, run_id = _upload_run(client, b"not a dicom at all", "bad.dcm")
        assert _wait(client, run_id, 60) == "error"
        row = STORAGE[client.pkg].get_run_status(run_id)
        assert row["error"]


class TestMultipartBinaryIntegrity:
    def test_trailing_crlf_bytes_preserved(self, client, tmp_path):
        payload = b"\x00\x01BINARY" + b"\r\n\r\n\n\r"
        s, up = client.upload("/api/upload", "file", "t.dcm", payload)
        assert s == 200
        with open(os.path.join(os.environ["UPLOAD_DIR"], up["stored_name"]),
                  "rb") as f:
            assert f.read() == payload

    def test_leading_crlf_preserved(self, client):
        payload = b"\r\nleading" + bytes(range(32)) + b"\r"
        s, up = client.upload("/api/upload", "file", "u.dcm", payload)
        with open(os.path.join(os.environ["UPLOAD_DIR"], up["stored_name"]),
                  "rb") as f:
            assert f.read() == payload


# ---------------------------------------------- both servers, one upload


def _masked(text: str, ids: list[str]) -> str:
    for i in ids:
        text = text.replace(i, "<id>")
    text = text.replace("one compiled program", "one batched pass")
    return parity._NUMBER.sub("#", text)


def test_same_upload_through_both_servers(both, tmp_path):
    """Each route on both apps: the same status code and JSON body (the
    index's name aside; ids, paths and numbers masked), the rows within
    ``parity.compare_rows``, the chat's stored-data summary, the same
    before/after PNG size."""
    content = _synthetic_dcm(tmp_path, "noisy")
    got = {}
    for pkg, c in both.items():
        up, run_id = _upload_run(c, content, "noisy.dcm")
        assert _wait(c, run_id) == "completed"
        ids = [up["file_id"], run_id]
        out = {"ids": ids, "run_id": run_id}
        for path in ("/", "/api/runs/deadbeef", "/api/runs/deadbeef/status",
                     f"/api/runs/{run_id}/status", f"/api/runs/{run_id}",
                     f"/api/runs/{run_id}/report",
                     f"/api/runs/{run_id}/logs"):
            s, _, body = c.request("GET", path)
            out[path.replace(run_id, "<id>")] = (s, json.loads(body))
        s, headers, png = c.request("GET", f"/api/runs/{run_id}/before_after")
        out["png"] = (s, headers["Content-Type"], png[:8], len(png) > 100)
        out["chat"] = c.post_json(f"/api/runs/{run_id}/chat",
                                  {"message": "what happened?"})
        out["chat_history"] = [m["role"] for m in STORAGE[pkg]
                               .get_chat_history(run_id)]
        out["row"] = STORAGE[pkg].get_run(run_id)
        got[pkg] = out
    j, p = got["jax"], got["port"]
    assert p["png"] == j["png"] == (200, "image/png", b"\x89PNG\r\n\x1a\n",
                                    True)
    assert p["chat_history"] == j["chat_history"] == ["user", "assistant"]
    assert p["chat"][0] == j["chat"][0] == 200
    assert "stored-data summary" in p["chat"][1]["reply"]
    assert (_masked(p["chat"][1]["reply"], p["ids"])
            == _masked(j["chat"][1]["reply"], j["ids"]))
    s_j, index_j = j["/"]
    s_p, index_p = p["/"]
    assert s_j == s_p == 200
    assert index_p["name"] != index_j["name"] and "mdx_torch" in index_p["name"]
    assert {k: v for k, v in index_p.items() if k != "name"} == {
        k: v for k, v in index_j.items() if k != "name"}
    for key in ("/api/runs/deadbeef", "/api/runs/deadbeef/status",
                "/api/runs/<id>/status", "/api/runs/<id>/report"):
        assert p[key][0] == j[key][0], key
        assert (_masked(json.dumps(p[key][1]), p["ids"])
                == _masked(json.dumps(j[key][1]), j["ids"])), key
    s_j, detail_j = j["/api/runs/<id>"]
    s_p, detail_p = p["/api/runs/<id>"]
    assert s_j == s_p == 200 and detail_p.keys() == detail_j.keys()
    assert p["/api/runs/<id>/logs"][0] == j["/api/runs/<id>/logs"][0] == 200
    bad, reported = parity.compare_rows(p["row"], j["row"], (SIZE, SIZE))
    assert not bad and not reported, (bad, reported)
    assert detail_p["issues"] == j["row"]["issues"]


# ------------------------------------------------ four runs at once, port


def test_four_concurrent_runs_equal_serial_runs(client, tmp_path):
    """Four runs posted back to back, which the four workers run at once
    (on both servers); each port row equal, field for field, to a serial
    ``run_pipeline`` of the same file on the same device."""
    kinds = ("noisy", "low_contrast", "clipped", "phantom")
    runs = {}
    for kind in kinds:
        up, run_id = _upload_run(client, _synthetic_dcm(tmp_path, kind),
                                 f"{kind}.dcm")
        runs[kind] = (up["stored_name"], run_id)
    for kind, (_, run_id) in runs.items():
        assert _wait(client, run_id) == "completed", kind
    if client.pkg == "jax":
        return
    for kind, (stored, run_id) in runs.items():
        serial = run_pipeline(
            os.path.join(os.environ["UPLOAD_DIR"], stored),
            str(tmp_path / "serial"), device="cpu")
        diff = parity.row_differences(PST.get_run(run_id),
                                      PST.get_run(serial["run_id"]))
        assert not diff, (kind, diff)


# ------------------------------------------------------ the genai flags


def test_genai_requests_end_as_jax_s(both, tmp_path, model_down):
    """``{"genai": true}``: the model call fails and both fall back to
    their deterministic runs.  With ``"autotune":
    true`` both run the sweep.  Both runs complete on both servers, each
    row within ``parity.compare_rows`` of the other package's, and the
    port's genai row equal to its deterministic row."""
    content = _synthetic_dcm(tmp_path, "noisy")
    rows = {}
    for pkg, c in both.items():
        for label, body in (("genai", {"genai": True}),
                            ("genai_autotune", {"genai": True,
                                                "autotune": True}),
                            ("deterministic", {})):
            if pkg == "jax" and label == "deterministic":
                continue
            _, run_id = _upload_run(c, content, "noisy.dcm", **body)
            assert _wait(c, run_id) == "completed", (pkg, label)
            rows[pkg, label] = STORAGE[pkg].get_run(run_id)
    for label in ("genai", "genai_autotune"):
        bad, reported = parity.compare_rows(rows["port", label],
                                            rows["jax", label], (SIZE, SIZE))
        assert not bad and not reported, (label, bad, reported)
    assert rows["port", "genai_autotune"]["genai_model"] == (
        "on-device autotune")
    assert json.loads(rows["port", "genai_autotune"]["plan_json"])[
        "params"] == json.loads(rows["jax", "genai_autotune"]["plan_json"])[
        "params"]
    assert not parity.row_differences(rows["port", "genai"],
                                      rows["port", "deterministic"])


def _tuning_script(llm):
    """Planner, two plans applied, validated and scored, the final plan,
    the explanation."""
    def plan(ops, **params):
        return json.dumps({"recommended_ops": ops, "params": params,
                           "rationale": "scripted"})

    first = plan(["denoise", "clahe"], clahe_clip_limit=0.02)
    final = plan(["denoise", "clahe", "unsharp", "bilateral", "tv_denoise"],
                 bilateral_d=5, tv_denoise_weight=0.05)

    def outputs(messages):
        return [json.loads(m["content"]) for m in messages
                if m.get("role") == "tool"]

    def call(name, **args):
        return _msg(None, [{"id": name, "function": {
            "name": name, "arguments": json.dumps(args)}}])

    def validate(messages):
        return call("tool_validate", original_id="original",
                    enhanced_id=outputs(messages)[-1]["enhanced_image_id"])

    def score(messages):
        return call("tool_score_plan",
                    validation_json=json.dumps(outputs(messages)[-1]))

    steps = [_msg(first)]
    for p in (first, final):
        steps += [call("tool_apply_enhancement", image_id="original",
                       plan_json=p), validate, score]
    return ScriptedTransport(llm, steps + [_msg(final), llm.LLMError("x"),
                                           llm.LLMError("y")])


def test_served_genai_run_equals_jax(both, tmp_path, clean_transport):
    """A served ``{"genai": true, "max_iters": 2}`` run takes the GenAI path
    on a worker thread (its own image store, the port's on the app's
    device): both complete with the same plan, ops, iterations and calls,
    the rows within ``parity.compare_rows``."""
    content = _synthetic_dcm(tmp_path, "noisy")
    rows = {}
    for pkg, c in both.items():
        tr = _tuning_script(LLM[pkg])
        LLM[pkg].set_transport(tr)
        _, run_id = _upload_run(c, content, "noisy.dcm", genai=True,
                                max_iters=2, model="gpt-5-mini")
        assert _wait(c, run_id) == "completed", pkg
        assert not tr.responses and len(tr.requests) == 10, pkg
        rows[pkg] = STORAGE[pkg].get_run(run_id)
    p, j = rows["port"], rows["jax"]
    bad, reported = parity.compare_rows(p, j, (SIZE, SIZE))
    assert not bad and not reported, (bad, reported)
    for key in ("genai_model", "genai_llm_calls", "plan_json",
                "applied_ops", "issues"):
        assert p[key] == j[key], key
    assert p["genai_llm_calls"] == 10 and p["genai_model"] == "gpt-5-mini"
    assert "tv_denoise" in p["applied_ops"]
    assert json.loads(p["plan_json"])["params"]["bilateral_d"] == 5
    tuning = [e for e in p["agent_logs"] if e["phase"] == "tuning"
              and e["event"] == "iteration"]
    assert len(tuning) == 2


# -------------------------------------------- the SPA's routes, the port


@pytest.fixture(scope="module")
def route_tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("routes")
    with pytest.MonkeyPatch.context() as mp:
        for k in ("MDX_DB_PATH", "UPLOAD_DIR", "OUTPUT_DIR"):
            mp.setenv(k, str(tmp / k.lower()))
        mp.setenv("MDX_DB_PATH", str(tmp / "mdx.db"))
        return {pkg: _app(pkg)._routes for pkg in PKGS}


@pytest.mark.parametrize("path", _client_paths())
def test_client_path_has_route(path, route_tables):
    assert any(regex.match(path) for regex, _m, _fn in route_tables["port"]), (
        f"client.ts requests {path!r} but no mdx_torch/serve/api.py route "
        f"matches it")


def test_route_tables_equal(route_tables):
    """The same patterns and methods, in the same order, as JAX's app."""
    def table(pkg):
        return [(regex.pattern, sorted(m), fn.__name__)
                for regex, m, fn in route_tables[pkg]]

    assert table("port") == table("jax") and len(table("port")) == 12


# --------------------------------------- tests/test_genai.py chat, client


def _msg(content=None, tool_calls=None):
    return {"choices": [{"message": {"content": content,
                                     "tool_calls": tool_calls or []}}]}


class ScriptedTransport:
    def __init__(self, llm, responses):
        self.llm, self.responses, self.requests = llm, list(responses), []

    def __call__(self, model, payload):
        self.requests.append((model, payload))
        if not self.responses:
            raise self.llm.LLMError("script exhausted")
        r = self.responses.pop(0)
        if isinstance(r, Exception):
            raise r
        # a step may be a function of the messages it answers (it reads
        # the random ids of enhanced images from the tool results)
        return r(payload["messages"]) if callable(r) else r


@pytest.fixture()
def clean_transport():
    yield
    for llm in LLM.values():
        llm.set_transport(None)


def _save_row(st, run_id, **over):
    row = dict(input_filename="x.dcm", metadata_summary={}, issues=[],
               metrics_before={}, metrics_after={}, plan_json="",
               validation={}, applied_ops=[], explainability={},
               report_path="", before_after_path="", agent_logs=[],
               status="completed")
    row.update(over)
    st.init_db()
    st.save_run(run_id=run_id, **row)


@pytest.mark.parametrize("pkg", PKGS)
class TestChat:
    def test_chat_without_llm_uses_stored_summary(self, tmp_path,
                                                  monkeypatch, pkg,
                                                  clean_transport):
        monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "c.db"))
        monkeypatch.delenv("OPENAI_API_KEY", raising=False)
        _save_row(STORAGE[pkg], "r1", issues=["noise"],
                  validation={"ssim": 0.91, "psnr": 30.0},
                  applied_ops=["denoise"])
        reply = CHAT[pkg].handle_chat("r1", "what happened?")
        assert "noise" in reply and "denoise" in reply
        assert reply == ("This run (r1) detected noise and applied denoise. "
                         "Validation: SSIM 0.910, PSNR 30.0 dB. (LLM chat is "
                         "unavailable; this is a stored-data summary.)")
        hist = STORAGE[pkg].get_chat_history("r1")
        assert [m["role"] for m in hist] == ["user", "assistant"]

    def test_chat_with_scripted_llm(self, tmp_path, monkeypatch, pkg,
                                    clean_transport):
        monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "c.db"))
        _save_row(STORAGE[pkg], "r2")
        tr = ScriptedTransport(LLM[pkg], [_msg("The run found no issues.")])
        LLM[pkg].set_transport(tr)
        reply = CHAT[pkg].handle_chat("r2", "any problems?")
        assert reply == "The run found no issues."
        sys_prompt = tr.requests[0][1]["messages"][0]["content"]
        assert "r2" in sys_prompt
        assert tr.requests[0][1]["messages"][0]["content"] == (
            CHAT[pkg].CHAT_SYSTEM_PROMPT.format(
                context=CHAT[pkg]._build_run_context(
                    STORAGE[pkg].get_run("r2"))))

    def test_chat_unknown_run(self, tmp_path, monkeypatch, pkg,
                              clean_transport):
        monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "c.db"))
        STORAGE[pkg].init_db()
        with pytest.raises(KeyError):
            CHAT[pkg].handle_chat("missing", "hi")


def test_chat_prompts_equal_jax(tmp_path, monkeypatch, clean_transport):
    """The port's chat sends JAX's messages (system prompt, the 10-message
    history window, the question) for the same stored run."""
    sent = {}
    for pkg in PKGS:
        monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / f"{pkg}.db"))
        _save_row(STORAGE[pkg], "r3", issues=["blur"],
                  applied_ops=["Unsharp mask"])
        for i in range(12):
            STORAGE[pkg].save_chat_message(
                "r3", ("user", "assistant", "system")[i % 3], f"m{i}")
        tr = ScriptedTransport(LLM[pkg], [_msg("ok")])
        LLM[pkg].set_transport(tr)
        assert CHAT[pkg].handle_chat("r3", "and now?", model="gpt-4o") == "ok"
        sent[pkg] = tr.requests
    assert sent["port"] == sent["jax"]
    assert len(sent["port"][0][1]["messages"]) == 1 + 10 + 1


@pytest.mark.parametrize("pkg", PKGS)
class TestClient:
    def test_temperature_omitted_for_reasoning_models(self, pkg,
                                                      clean_transport):
        llm = LLM[pkg]
        tr = ScriptedTransport(llm, [_msg("hi"), _msg("hi")])
        llm.set_transport(tr)
        llm.chat_completion("gpt-4o", [{"role": "user", "content": "x"}])
        llm.chat_completion("o4-mini", [{"role": "user", "content": "x"}])
        assert "temperature" in tr.requests[0][1]
        assert "temperature" not in tr.requests[1][1]

    def test_extract_json_variants(self, pkg):
        llm = LLM[pkg]
        assert llm.extract_json('{"a": 1}') == {"a": 1}
        assert llm.extract_json('```json\n{"a": 1}\n```') == {"a": 1}
        assert llm.extract_json('Best plan:\n{"a": {"b": 2}} done') == \
            {"a": {"b": 2}}
        with pytest.raises(llm.LLMError):
            llm.extract_json("no json here")


@pytest.mark.parametrize("pkg", PKGS)
class TestHttpTransport:
    """The stdlib HTTP transport against a server on this machine: headers,
    payload shape, retry on 5xx, failure surfacing."""

    @pytest.fixture()
    def server(self, monkeypatch, pkg):
        import http.server
        import threading

        state = {"requests": [], "responses": []}

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                state["requests"].append(
                    (self.path, dict(self.headers), json.loads(body)))
                status, payload = (state["responses"].pop(0)
                                   if state["responses"] else (200, _msg("ok")))
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):
                pass

        httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        monkeypatch.setenv("OPENAI_API_KEY", "test-key-123")
        monkeypatch.setattr(LLM[pkg], "DEFAULT_BASE_URL",
                            f"http://127.0.0.1:{port}/v1")
        monkeypatch.setattr(LLM[pkg], "_transport", None)
        monkeypatch.setattr(LLM[pkg].time, "sleep", lambda s: None)
        yield state
        httpd.shutdown()

    def test_request_shape_and_auth(self, server, pkg):
        tool = {"type": "function", "function": {"name": "tool_get_metrics",
                                                 "parameters": {}}}
        msg = LLM[pkg].chat_completion(
            "gpt-4o", [{"role": "user", "content": "hi"}], tools=[tool])
        assert msg["content"] == "ok"
        path, headers, payload = server["requests"][0]
        assert path == "/v1/chat/completions"
        assert headers["Authorization"] == "Bearer test-key-123"
        assert payload["model"] == "gpt-4o"
        assert payload["tools"][0]["function"]["name"] == "tool_get_metrics"

    def test_retry_on_500_then_success(self, server, pkg):
        server["responses"] = [(500, {"error": "boom"}),
                               (200, _msg("recovered"))]
        msg = LLM[pkg].chat_completion("gpt-4o",
                                       [{"role": "user", "content": "hi"}])
        assert msg["content"] == "recovered"
        assert len(server["requests"]) == 2

    def test_client_error_raises(self, server, pkg):
        server["responses"] = [(401, {"error": "bad key"})]
        with pytest.raises(LLM[pkg].LLMError, match="401"):
            LLM[pkg].chat_completion("gpt-4o",
                                     [{"role": "user", "content": "hi"}])

    def test_missing_key_raises(self, server, pkg, monkeypatch):
        monkeypatch.delenv("OPENAI_API_KEY")
        with pytest.raises(LLM[pkg].LLMError, match="OPENAI_API_KEY"):
            LLM[pkg].chat_completion("gpt-4o",
                                     [{"role": "user", "content": "hi"}])


# ------------------------------------------------------------- the device


def test_create_app_without_a_card_raises(env):
    """No fallback hides the card: an app made for the default device on a
    machine without one fails at start, with ``resolve_device``'s
    message, and accepts no run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from mdx_torch.serve import api, config, legacy

    importlib.reload(config)
    with pytest.raises(RuntimeError, match=re.escape(
            "mdx_torch runs on device 'cuda', but torch.cuda.is_available() "
            "is False")):
        api.create_app()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        legacy.create_legacy_app()
    assert not (env / "uploads").exists() and not (env / "mdx.db").exists()
