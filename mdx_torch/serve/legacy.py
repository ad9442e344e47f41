"""Legacy server-rendered web UI (ref app.py + templates/ + static/): the
port's copy of ``mdx/serve/legacy.py``.

Synchronous Flask/Jinja-style pages on the from-scratch WSGI router:
upload form → blocking pipeline run on the app's device → result page,
reports list/detail, logs page, a chat endpoint, markdown→HTML report
rendering, and double-submit-cookie CSRF protection (flask-wtf equivalent,
built from stdlib hmac).  Jinja2 renders the repo's ``templates/`` and the
app serves its ``static/``, where they are; Jinja2 and ``markdown`` are
imported when the app is made and when a report is rendered, not with the
module.  The port's PNG writer needs no matplotlib.

    PORT=8000 python -m mdx_torch.serve.legacy
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import secrets
import uuid

from mdx_torch.pipeline import storage
from mdx_torch.pipeline.runner import resolve_device
from mdx_torch.serve import config
from mdx_torch.serve.wsgi import (App, Request, Response, jsonify,
                                  secure_filename, send_file)

logger = logging.getLogger(__name__)

_TEMPLATE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "templates")
_STATIC_DIR = os.path.join(os.path.dirname(_TEMPLATE_DIR), "static")


def _jinja_env():
    import jinja2

    env = jinja2.Environment(
        loader=jinja2.FileSystemLoader(_TEMPLATE_DIR),
        autoescape=True)
    env.filters["markdown"] = _markdown_to_html
    return env


def _markdown_to_html(md: str) -> str:
    """Markdown → HTML with raw-HTML neutralised.

    Report markdown embeds attacker-controllable strings (DICOM metadata,
    LLM output); python-markdown passes raw HTML through, so angle
    brackets are escaped FIRST — markdown syntax (headers, tables, bold,
    code) survives, inline HTML becomes inert text (stored-XSS defence,
    rendered under ``|safe`` in result/report templates)."""
    import html

    md = html.escape(md, quote=False)
    try:
        import markdown as md_lib

        return md_lib.markdown(md, extensions=["tables", "fenced_code"])
    except Exception:
        return f"<pre>{md}</pre>"


# -- CSRF: double-submit token keyed on SECRET_KEY ------------------------


def _csrf_token() -> str:
    nonce = secrets.token_hex(16)
    sig = hmac.new(config.SECRET_KEY.encode(), nonce.encode(),
                   hashlib.sha256).hexdigest()[:32]
    return f"{nonce}.{sig}"


def _csrf_ok(token: str) -> bool:
    try:
        nonce, sig = token.split(".", 1)
    except ValueError:
        return False
    want = hmac.new(config.SECRET_KEY.encode(), nonce.encode(),
                    hashlib.sha256).hexdigest()[:32]
    return hmac.compare_digest(sig, want)


def _form_fields(req: Request) -> dict[str, str]:
    """Parse non-file fields of a multipart or urlencoded POST body."""
    ctype = req.environ.get("CONTENT_TYPE", "")
    if "multipart/form-data" in ctype:
        return {k: v[1].decode("utf-8", "replace")
                for k, v in req.files().items() if not v[0]}
    from urllib.parse import parse_qsl

    return dict(parse_qsl(req.body.decode("utf-8", "replace")))


def _cookie_token(req: Request) -> str:
    cookies = req.environ.get("HTTP_COOKIE", "")
    for chunk in cookies.split(";"):
        k, _, v = chunk.strip().partition("=")
        if k == "mdx_csrf":
            return v
    return ""


def create_legacy_app(device="cuda") -> App:
    """The legacy UI's app; its runs go to ``device``, which
    :func:`resolve_device` checks first."""
    dev = resolve_device(device)
    config.apply_to_env()
    app = App(max_content_length=config.MAX_CONTENT_LENGTH)
    # Browser-facing HTML app: same-origin only (the wildcard-CORS JSON API
    # is a separate surface) — wildcard CORS here would let any origin read
    # a fresh CSRF token out of the page.
    app.cors = False
    env = _jinja_env()

    def _html_error(status: int, message: str) -> Response:
        body = env.get_template("error.html").render(
            message=message, csrf_token="").encode("utf-8")
        return Response(body, status,
                        [("Content-Type", "text/html; charset=utf-8")])

    app.error_renderer = _html_error
    os.makedirs(config.UPLOAD_DIR, exist_ok=True)
    os.makedirs(config.OUTPUT_DIR, exist_ok=True)
    storage.init_db()
    repaired = storage.mark_orphaned_runs()
    if repaired:
        logger.warning("Marked %d orphaned run(s) from a previous"
                       " process as error.", repaired)

    def page(req: Request, template: str, status: int = 200,
             **ctx) -> Response:
        # Reuse the visitor's existing valid token — minting a fresh one on
        # every render would invalidate an upload form still open in
        # another tab the moment any other page is viewed.
        existing = _cookie_token(req)
        token = existing if _csrf_ok(existing) else _csrf_token()
        ctx["csrf_token"] = token
        body = env.get_template(template).render(**ctx).encode("utf-8")
        # double-submit cookie: the form token must match this cookie on POST
        return Response(body, status, [
            ("Content-Type", "text/html; charset=utf-8"),
            ("Set-Cookie",
             f"mdx_csrf={token}; Path=/; SameSite=Strict; HttpOnly"),
        ])

    @app.route("/")
    def index(req: Request):
        return page(req, "upload.html")

    @app.route("/run", methods=["POST"])
    def run(req: Request):
        fields = _form_fields(req)
        token = fields.get("csrf_token", "")
        if (not _csrf_ok(token)
                or not hmac.compare_digest(token, _cookie_token(req))):
            return page(req, "error.html", 400, message="Invalid CSRF token")
        files = req.files()
        if "file" not in files or not files["file"][0]:
            return page(req, "error.html", 400, message="No file selected")
        filename, content = files["file"]
        ext = os.path.splitext(filename)[1].lower()
        if ext not in (".dcm", ".dicom"):
            return page(req, "error.html", 400,
                        message=f"Unsupported file type: {ext}")
        file_id = uuid.uuid4().hex[:12]
        stored = f"{file_id}_{secure_filename(filename) or 'scan.dcm'}"
        path = os.path.join(config.UPLOAD_DIR, stored)
        with open(path, "wb") as f:
            f.write(content)

        genai = fields.get("genai") == "on"
        try:
            max_iters = int(fields.get("max_iters") or config.MAX_ITERS)
        except (TypeError, ValueError):
            return page(req, "error.html", 400,
                        message="max_iters must be an integer")
        max_iters = max(1, min(max_iters, 10))
        from mdx_torch.pipeline.runner import run_pipeline

        try:
            ctx = run_pipeline(
                input_path=path, output_dir=config.OUTPUT_DIR,
                genai=genai, model=fields.get("model") or None,
                max_iters=max_iters,
                save_artifacts=True, no_show=True, device=dev)
        except Exception as exc:
            logger.exception("Synchronous run failed: %s", exc)
            return page(req, "error.html", 500,
                        message="The pipeline run failed — see the server "
                                "log for details.")
        return _redirect(f"/result/{ctx['run_id']}")

    @app.route("/result/<run_id>")
    def result(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return page(req, "error.html", 404, message="Run not found")
        return page(req, "result.html", run=data,
                    report_html=_report_html(data))

    @app.route("/reports")
    def reports(req: Request):
        return page(req, "reports.html", runs=storage.list_runs(limit=100))

    @app.route("/reports/<run_id>")
    def report_detail(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return page(req, "error.html", 404, message="Run not found")
        return page(req, "report_detail.html", run=data,
                    report_html=_report_html(data),
                    chat_history=storage.get_chat_history(run_id))

    @app.route("/reports/<run_id>/download")
    def download_report(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return page(req, "error.html", 404, message="Run not found")
        rp = data.get("report_path", "")
        if rp and os.path.isfile(rp):
            resp = send_file(rp, mimetype="text/markdown")
            resp.headers.append(
                ("Content-Disposition",
                 f'attachment; filename="{run_id}_report.md"'))
            return resp
        return page(req, "error.html", 404, message="Report file not found")

    @app.route("/logs/<run_id>")
    def logs(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return page(req, "error.html", 404, message="Run not found")
        return page(req, "logs.html", run=data,
                    logs=data.get("agent_logs", []))

    @app.route("/api/chat", methods=["POST"])
    def api_chat(req: Request):
        # state-changing endpoint: same double-submit rule as /run (the
        # token travels in a header, set by static/chat.js from the page)
        header_token = req.environ.get("HTTP_X_CSRF_TOKEN", "")
        if (not _csrf_ok(header_token)
                or not hmac.compare_digest(header_token,
                                           _cookie_token(req))):
            return {"error": "Invalid CSRF token"}, 400
        data = req.json()
        run_id = data.get("run_id", "")
        message = (data.get("message") or "").strip()
        if not run_id or not message:
            return {"error": "run_id and message are required"}, 400
        if len(message) > 2000:
            return {"error": "Message too long (max 2000 chars)"}, 400
        try:
            from mdx_torch.pipeline.chat import handle_chat

            return {"reply": handle_chat(run_id, message)}, 200
        except KeyError:
            return {"error": "Run not found"}, 404
        except Exception:
            logger.exception("chat failed")
            return {"error": "Chat processing failed"}, 500

    @app.route("/outputs/<path:filename>")
    def serve_output(req: Request, filename: str):
        return _serve(config.OUTPUT_DIR, filename)

    @app.route("/uploads/<path:filename>")
    def serve_upload(req: Request, filename: str):
        return _serve(config.UPLOAD_DIR, filename)

    @app.route("/static/<path:filename>")
    def serve_static(req: Request, filename: str):
        return _serve(_STATIC_DIR, filename)

    return app


def _report_html(run: dict) -> str:
    rp = run.get("report_path", "")
    if rp and os.path.isfile(rp):
        with open(rp, encoding="utf-8") as f:
            return _markdown_to_html(f.read())
    return "<p><em>No report file on disk for this run.</em></p>"


def _serve(root: str, filename: str):
    full = os.path.realpath(os.path.join(root, filename))
    if not full.startswith(os.path.realpath(root) + os.sep):
        return jsonify({"error": "Not found"}, 404)
    if os.path.isfile(full):
        return send_file(full)
    return jsonify({"error": "File not found"}, 404)


def _redirect(location: str) -> Response:
    return Response(b"", 302, [("Location", location)])


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    create_legacy_app().run(
        host="0.0.0.0", port=int(os.environ.get("PORT", "8000")))


if __name__ == "__main__":
    main()
