"""JSON REST API — the reference's 12 routes (ref backend/app.py:59-242)
on the from-scratch WSGI router: the port's copy of ``mdx/serve/api.py``.

Route-for-route behaviourally compatible with the JAX package's server:
same paths, methods, status codes, and response shapes (the index's
``name`` names the port), so the React SPA's typed client
(frontend/src/api/client.ts) works against either backend.  Runs go to
:func:`mdx_torch.pipeline.runner.run_pipeline` on the app's device, the
card unless ``create_app(device="cpu")``; an app without its device fails
at start (no run is accepted that would then fail).

    PORT=5000 python -m mdx_torch.serve.api
"""

from __future__ import annotations

import logging
import os
import uuid

from mdx_torch.pipeline import storage
from mdx_torch.pipeline.runner import resolve_device
from mdx_torch.serve import config
from mdx_torch.serve.executor import get_run_status, start_run
from mdx_torch.serve.wsgi import (App, Request, jsonify, secure_filename,
                                  send_file)

logger = logging.getLogger(__name__)

API_VERSION = "1.0.0"
NAME = "mdx_torch — Medical Imaging QA (CUDA) - Backend API"


def create_app(device="cuda") -> App:
    """Application factory (ref backend/app.py:39-257); runs go to
    ``device``, which :func:`resolve_device` checks first."""
    dev = resolve_device(device)
    config.apply_to_env()
    app = App(max_content_length=config.MAX_CONTENT_LENGTH)

    os.makedirs(config.UPLOAD_DIR, exist_ok=True)
    os.makedirs(config.OUTPUT_DIR, exist_ok=True)
    storage.init_db()
    repaired = storage.mark_orphaned_runs()
    if repaired:
        logger.warning("Marked %d orphaned run(s) from a previous"
                       " process as error.", repaired)

    # -- Root / health ---------------------------------------------------

    @app.route("/")
    def index(req: Request):
        return {
            "name": NAME,
            "version": API_VERSION,
            "status": "running",
            "endpoints": {
                "upload": "POST /api/upload",
                "run": "POST /api/run",
                "runs": "GET /api/runs",
                "run_detail": "GET /api/runs/<id>",
                "run_status": "GET /api/runs/<id>/status",
                "report": "GET /api/runs/<id>/report",
                "before_after": "GET /api/runs/<id>/before_after",
                "chat": "POST /api/runs/<id>/chat",
                "logs": "GET /api/runs/<id>/logs",
            },
            "docs": "See README.md for full API documentation",
        }

    # -- Upload ------------------------------------------------------------

    @app.route("/api/upload", methods=["POST"])
    def api_upload(req: Request):
        files = req.files()
        if "file" not in files:
            return {"error": "No file part in request"}, 400
        filename, content = files["file"]
        if not filename:
            return {"error": "No file selected"}, 400
        ext = os.path.splitext(filename)[1].lower()
        if ext not in {".dcm", ".dicom"}:
            return {"error": f"Unsupported file type: {ext}"}, 400
        file_id = uuid.uuid4().hex[:12]
        safe_name = secure_filename(filename) or f"{file_id}.dcm"
        stored_name = f"{file_id}_{safe_name}"
        with open(os.path.join(config.UPLOAD_DIR, stored_name), "wb") as f:
            f.write(content)
        return {"file_id": file_id, "filename": safe_name,
                "stored_name": stored_name}, 200

    # -- Run ---------------------------------------------------------------

    @app.route("/api/run", methods=["POST"])
    def api_run(req: Request):
        data = req.json()
        file_id = data.get("file_id")
        if not file_id:
            return {"error": "file_id is required"}, 400
        stored = _find_upload(file_id)
        if stored is None:
            return {"error": f"Upload {file_id} not found"}, 404
        max_iters = data.get("max_iters")
        run_id = start_run(
            file_path=os.path.join(config.UPLOAD_DIR, stored),
            genai=bool(data.get("genai", False)),
            model=data.get("model") or None,
            max_iters=int(max_iters) if max_iters is not None else None,
            autotune=bool(data.get("autotune", False)), device=dev)
        return {"run_id": run_id, "status": "pending"}, 202

    # -- Runs list ---------------------------------------------------------

    @app.route("/api/runs", methods=["GET"])
    def api_runs(req: Request):
        limit = req.arg("limit", 100, int)
        offset = req.arg("offset", 0, int)
        runs = storage.list_runs(limit=limit, offset=offset)
        summaries = [{
            "run_id": r["run_id"],
            "timestamp": r.get("created_at", ""),
            "input_filename": r.get("input_filename", ""),
            "status": r.get("status", "unknown"),
            "issues": r.get("issues", []),
            "genai_model": r.get("genai_model", ""),
        } for r in runs]
        return {"runs": summaries}, 200

    # -- Run detail --------------------------------------------------------

    @app.route("/api/runs/<run_id>", methods=["GET"])
    def api_run_detail(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return {"error": "Run not found"}, 404
        data["chat_history"] = storage.get_chat_history(run_id)
        return data, 200

    # -- Status (lightweight polling) --------------------------------------

    @app.route("/api/runs/<run_id>/status", methods=["GET"])
    def api_run_status(req: Request, run_id: str):
        status = get_run_status(run_id)
        if status == "not_found":
            return {"error": "Run not found"}, 404
        return {"run_id": run_id, "status": status}, 200

    # -- Report markdown ---------------------------------------------------

    @app.route("/api/runs/<run_id>/report", methods=["GET"])
    def api_report(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return {"error": "Run not found"}, 404
        report_path = data.get("report_path", "")
        if report_path and os.path.isfile(report_path):
            with open(report_path, encoding="utf-8") as f:
                return {"markdown": f.read()}, 200
        return {"markdown": "", "note": "Report file not found"}, 200

    # -- Before/after image ------------------------------------------------

    @app.route("/api/runs/<run_id>/before_after", methods=["GET"])
    def api_before_after(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return {"error": "Run not found"}, 404
        ba = data.get("before_after_path", "")
        if ba and os.path.isfile(ba):
            return send_file(ba, mimetype="image/png")
        return {"error": "Image not found"}, 404

    # -- Chat --------------------------------------------------------------

    @app.route("/api/runs/<run_id>/chat", methods=["POST"])
    def api_chat(req: Request, run_id: str):
        data = req.json()
        message = (data.get("message") or "").strip()
        if not message:
            return {"error": "message is required"}, 400
        if len(message) > 2000:
            return {"error": "Message too long (max 2000 chars)"}, 400
        try:
            from mdx_torch.pipeline.chat import handle_chat

            reply = handle_chat(run_id, message,
                                model=data.get("model") or None)
            return {"reply": reply}, 200
        except Exception as exc:
            logger.exception("Chat error for run %s: %s", run_id, exc)
            return {"error": "Chat processing failed"}, 500

    # -- Logs --------------------------------------------------------------

    @app.route("/api/runs/<run_id>/logs", methods=["GET"])
    def api_logs(req: Request, run_id: str):
        data = storage.get_run(run_id)
        if data is None:
            return {"error": "Run not found"}, 404
        return {"logs": data.get("agent_logs", [])}, 200

    # -- Raw artifact files ------------------------------------------------

    @app.route("/api/files/outputs/<path:filename>")
    def api_serve_output(req: Request, filename: str):
        return _serve_from(config.OUTPUT_DIR, filename)

    @app.route("/api/files/uploads/<path:filename>")
    def api_serve_upload(req: Request, filename: str):
        return _serve_from(config.UPLOAD_DIR, filename)

    return app


def _serve_from(root: str, filename: str):
    full = os.path.realpath(os.path.join(root, filename))
    if not full.startswith(os.path.realpath(root) + os.sep):
        return jsonify({"error": "Not found"}, 404)
    if os.path.isfile(full):
        return send_file(full)
    return jsonify({"error": "File not found"}, 404)


def _find_upload(file_id: str) -> str | None:
    try:
        for name in os.listdir(config.UPLOAD_DIR):
            if name.startswith(file_id):
                return name
    except OSError:
        pass
    return None


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    create_app().run(host="0.0.0.0", port=int(os.environ.get("PORT", "5000")))


if __name__ == "__main__":
    main()
