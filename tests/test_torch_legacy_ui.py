"""The port's legacy server-rendered UI (``mdx_torch.serve.legacy``) against
the JAX package's (``mdx.serve.legacy``), on the CPU.

Every case of ``tests/test_legacy_ui.py`` runs on both packages (the
``client`` fixture is parametrised on the package; the port's app on
``device="cpu"``): the pages, the CSRF double-submit rule, the static
files, the synchronous run, the stored-XSS defence, the HTML error pages.
Both apps render the repo's ``templates/`` and serve its ``static/``.  The
full run's DB row is held to JAX's, for the same upload, by
``parity.compare_rows``, and its pages to JAX's with the run's ids and
numbers masked; the chat endpoint answers both apps alike with the
stored-data summary.
"""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from test_legacy_ui import _Client, _csrf

from mdx.pipeline import storage as JST

from mdx_torch import parity
from mdx_torch.io import write_synthetic_dicom
from mdx_torch.pipeline import storage as PST

torch.set_num_threads(1)

PKGS = ("jax", "port")
STORAGE = {"jax": JST, "port": PST}


def _app(pkg: str):
    if pkg == "jax":
        from mdx.serve import config, legacy
    else:
        from mdx_torch.serve import config, legacy
    importlib.reload(config)
    importlib.reload(legacy)
    return (legacy.create_legacy_app() if pkg == "jax"
            else legacy.create_legacy_app(device="cpu"))


@pytest.fixture()
def env(tmp_path, monkeypatch):
    monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / "mdx.db"))
    monkeypatch.setenv("UPLOAD_DIR", str(tmp_path / "uploads"))
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "outputs"))
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    return tmp_path


@pytest.fixture(params=PKGS)
def client(request, env):
    return _Client(_app(request.param))


class TestPages:
    def test_upload_page(self, client):
        s, _, body = client.get("/")
        assert s == 200 and b"DICOM" in body and b"csrf_token" in body

    def test_reports_empty(self, client):
        s, _, body = client.get("/reports")
        assert s == 200 and b"No runs yet" in body

    def test_unknown_run_404(self, client):
        s, _, _ = client.get("/reports/deadbeef")
        assert s == 404

    def test_unknown_route_404(self, client):
        s, _, _ = client.get("/nope")
        assert s == 404

    def test_run_without_file(self, client):
        token = _csrf(client)
        s, _, body = client.post_multipart("/run",
                                           fields={"csrf_token": token})
        assert s == 400 and b"No file selected" in body

    def test_run_bad_csrf(self, client):
        s, _, body = client.post_multipart(
            "/run", fields={"csrf_token": "bogus.bogus"},
            files={"file": ("a.dcm", b"xx")})
        assert s == 400 and b"CSRF" in body

    def test_run_valid_token_but_no_cookie(self, client):
        token = _csrf(client)
        client.cookies.clear()
        s, _, body = client.post_multipart(
            "/run", fields={"csrf_token": token},
            files={"file": ("a.dcm", b"xx")})
        assert s == 400 and b"CSRF" in body

    def test_static_served(self, client):
        s, headers, body = client.get("/static/style.css")
        assert s == 200 and b"topbar" in body

    def test_chat_validation(self, client):
        s, _, body = client.request(
            "POST", "/api/chat", json.dumps({}).encode(),
            "application/json")
        assert s == 400


class TestSynchronousRun:
    def test_full_run_flow(self, client, tmp_path):
        p = tmp_path / "n.dcm"
        write_synthetic_dicom(str(p), kind="noisy", size=64)
        token = _csrf(client)
        s, headers, _ = client.post_multipart(
            "/run", fields={"csrf_token": token},
            files={"file": ("n.dcm", p.read_bytes())})
        assert s == 302
        loc = headers["Location"]
        assert loc.startswith("/result/")

        s, _, body = client.get(loc)
        assert s == 200 and b"noise" in body

        run_id = loc.split("/")[-1]
        s, _, body = client.get(f"/reports/{run_id}")
        assert s == 200 and b"chat" in body

        s, _, body = client.get(f"/reports/{run_id}/download")
        assert s == 200 and b"#" in body

        s, _, body = client.get(f"/logs/{run_id}")
        assert s == 200


class TestSecurityHardening:
    def test_report_html_neutralises_raw_html(self, client, tmp_path):
        p = tmp_path / "x.dcm"
        write_synthetic_dicom(
            str(p), kind="noisy", size=64,
            study_description='<img src=x onerror=alert(1)>')
        token = _csrf(client)
        s, headers, _ = client.post_multipart(
            "/run", fields={"csrf_token": token},
            files={"file": ("x.dcm", p.read_bytes())})
        assert s == 302
        s, _, body = client.get(headers["Location"])
        assert b"<img src=x onerror" not in body
        assert b"&lt;img" in body

    def test_chat_requires_csrf(self, client, tmp_path):
        s, _, body = client.request(
            "POST", "/api/chat",
            json.dumps({"run_id": "x", "message": "hi"}).encode(),
            "application/json")
        assert s == 400 and b"CSRF" in body

    def test_page_view_does_not_rotate_token(self, client):
        t1 = _csrf(client)
        client.get("/reports")
        t2 = _csrf(client)
        assert t1 == t2

    def test_framework_errors_render_html(self, client):
        s, headers, body = client.get("/definitely/not/here")
        assert s == 404
        assert headers["Content-Type"].startswith("text/html")
        assert b"Something went wrong" in body

    def test_bad_max_iters_is_400(self, client, tmp_path):
        p = tmp_path / "n.dcm"
        write_synthetic_dicom(str(p), kind="noisy", size=64)
        token = _csrf(client)
        s, _, body = client.post_multipart(
            "/run", fields={"csrf_token": token, "max_iters": "abc"},
            files={"file": ("n.dcm", p.read_bytes())})
        assert s == 400 and b"max_iters" in body


# ------------------------------------------------- both apps, one upload


def _masked(body: bytes, ids: list[str]) -> str:
    text = body.decode("utf-8")
    for i in ids:
        text = text.replace(i, "<id>")
    return parity._NUMBER.sub("#", text)


def _chat(client, run_id: str, token: str) -> tuple[int, bytes]:
    """``POST /api/chat`` with the CSRF token in its header, as
    ``static/chat.js`` sends it, and the client's cookies."""
    import io

    body = json.dumps({"run_id": run_id, "message": "what happened?"}
                      ).encode()
    captured = {}

    def start_response(status, headers):
        captured["status"] = int(status.split()[0])

    environ = {
        "REQUEST_METHOD": "POST", "PATH_INFO": "/api/chat",
        "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
        "CONTENT_TYPE": "application/json", "wsgi.input": io.BytesIO(body),
        "HTTP_X_CSRF_TOKEN": token,
        "HTTP_COOKIE": "; ".join(f"{k}={v}"
                                 for k, v in client.cookies.items())}
    payload = b"".join(client.app(environ, start_response))
    return captured["status"], payload


def test_full_run_flow_row_equals_jax(env, tmp_path, monkeypatch):
    """The same upload through both apps: the DB rows within
    ``parity.compare_rows``, the result, report, download and logs pages
    equal with the run's ids and numbers masked (and the CSRF tokens),
    and the chat's stored-data summary alike."""
    p = tmp_path / "n.dcm"
    write_synthetic_dicom(str(p), kind="noisy", size=64)
    got = {}
    for pkg in PKGS:
        # a DB each, so that each reports page lists its own run
        monkeypatch.setenv("MDX_DB_PATH", str(tmp_path / f"{pkg}.db"))
        c = _Client(_app(pkg))
        token = _csrf(c)
        s, headers, _ = c.post_multipart(
            "/run", fields={"csrf_token": token},
            files={"file": ("n.dcm", p.read_bytes())})
        assert s == 302
        run_id = headers["Location"].split("/")[-1]
        row = STORAGE[pkg].get_run(run_id)
        stored = row["input_filename"].split("_")[0]
        ids = [run_id, stored, token]
        pages = {}
        for path in (f"/result/{run_id}", f"/reports/{run_id}",
                     f"/reports/{run_id}/download", f"/logs/{run_id}",
                     "/reports"):
            s, headers, body = c.get(path)
            pages[path.replace(run_id, "<id>")] = (
                s, headers["Content-Type"], _masked(body, ids))
        s, body = _chat(c, run_id, token)
        got[pkg] = {"row": row, "pages": pages,
                    "chat": (s, _masked(body, ids))}
    j, q = got["jax"], got["port"]
    bad, reported = parity.compare_rows(q["row"], j["row"], (64, 64))
    assert not bad and not reported, (bad, reported)
    assert q["chat"] == j["chat"] and q["chat"][0] == 200
    assert "stored-data summary" in q["chat"][1]
    for path, page in j["pages"].items():
        if path.startswith("/logs/"):
            # the trace lists each package's own phases and their times
            assert q["pages"][path][:2] == page[:2], path
        else:
            assert q["pages"][path] == page, path
