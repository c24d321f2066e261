"""The kernel-selection point, the compile-cache helper, and the stdlib HTTP
layer's validation and /metrics text."""

import http.client
import json
import os

import pytest
import jax

from rag_serving_system import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# kernel selection
# ---------------------------------------------------------------------------

def test_kernel_table_rows():
    assert backend.kernels("gpu") == backend.Kernels(
        prefill_attention="cudnn", packed_attention="pallas_triton",
        warmup_workers=1)
    assert backend.kernels("cpu") == backend.Kernels(
        prefill_attention="einsum", packed_attention="einsum",
        warmup_workers=8)


def test_kernels_default_to_jax_backend():
    assert backend.kernels() == backend.kernels(jax.default_backend())


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_kernels_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no kernels registered"):
        backend.kernels(platform)


def test_require_platform():
    backend.require_platform("cpu")          # what the tests run on
    with pytest.raises(RuntimeError):
        backend.require_platform("metal")


def test_configure_xla_flags_adds_and_respects(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    got = backend.configure_xla_flags()
    assert got.split() == ["--xla_force_host_platform_device_count=8",
                           *backend.XLA_FLAGS]
    assert backend.configure_xla_flags() == got        # idempotent
    # a value the environment chose wins over the program's default
    monkeypatch.setenv("XLA_FLAGS", "--xla_gpu_enable_command_buffer=FUSION")
    assert (backend.configure_xla_flags()
            == "--xla_gpu_enable_command_buffer=FUSION")


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

@pytest.fixture
def cache_config():
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_compile_cache_honours_env(monkeypatch, cache_config, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = backend.setup_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,field", [
    ({"k": 2}, "query"),
    ({"query": 7}, "query"),
    ({"query": "x" * 100_001}, "query"),
    ({"query": "x", "k": "lots"}, "k"),
    ({"query": "x", "k": 0}, "k"),
    ({"query": "x", "k": 1025}, "k"),
    ({"query": "x", "k": True}, "k"),
    ({"query": "x", "k": 2.5}, "k"),
    ({"query": "x", "max_new_tokens": 0}, "max_new_tokens"),
    ({"query": "x", "max_new_tokens": "many"}, "max_new_tokens"),
])
def test_query_request_rejects(body, field):
    from rag_serving_system.api.models import QueryRequest, ValidationError

    with pytest.raises(ValidationError) as e:
        QueryRequest.model_validate(body)
    assert [err["loc"] for err in e.value.errors()] == [("body", field)]


def test_query_request_accepts_lax_ints_and_defaults():
    from rag_serving_system.api.models import QueryRequest, ValidationError

    r = QueryRequest.model_validate({"query": "q", "k": "3",
                                     "max_new_tokens": 4.0})
    assert (r.query, r.k, r.max_new_tokens) == ("q", 3, 4)
    r = QueryRequest.model_validate({"query": "q"})
    assert (r.k, r.max_new_tokens) == (2, None)
    with pytest.raises(ValidationError):
        QueryRequest.model_validate(["not", "an", "object"])


def test_metrics_exposition_format():
    from rag_serving_system.api.endpoints import _exposition

    text = _exposition([
        ("rag_requests_total", "counter", "Requests accepted", [({}, 3)]),
        ("rag_stage_seconds", "gauge", "Mean seconds per stage",
         [({"stage": "generate"}, 0.25), ({"stage": "embed"}, 0.5)]),
    ])
    assert text.splitlines() == [
        "# HELP rag_requests_total Requests accepted",
        "# TYPE rag_requests_total counter",
        "rag_requests_total 3.0",
        "# HELP rag_stage_seconds Mean seconds per stage",
        "# TYPE rag_stage_seconds gauge",
        'rag_stage_seconds{stage="generate"} 0.25',
        'rag_stage_seconds{stage="embed"} 0.5',
    ]


@pytest.fixture
def api_server():
    from rag_serving_system.api.endpoints import ServerThread, create_api
    from rag_serving_system.core.request_queue import RequestQueue

    server = ServerThread(create_api(RequestQueue(max_batch_size=4))).start()
    yield server
    server.stop()


def test_http_keep_alive_routes_and_errors(api_server):
    conn = http.client.HTTPConnection("127.0.0.1", api_server.port, timeout=10)

    def call(method, path, body=None):
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()

    # several requests on ONE connection (keep-alive)
    status, _, body = call("POST", "/rag", json.dumps({"query": "hello"}))
    assert status == 200 and json.loads(body)["status"] == "processing"
    assert call("POST", "/rag", "{not json")[0] == 422
    status, _, body = call("POST", "/rag", json.dumps({"query": "x", "k": 0}))
    assert status == 422 and json.loads(body)["detail"][0]["loc"] == ["body", "k"]
    assert call("GET", "/nope")[0] == 404
    assert call("GET", "/rag")[0] == 405
    status, ctype, body = call("GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    text = body.decode()
    assert "# TYPE rag_requests_total counter" in text
    assert "rag_requests_total 1.0" in text
    assert "rag_queue_size 1.0" in text
    assert call("GET", "/health")[2] == b'{"status": "healthy"}'
    conn.close()


def test_role_api_never_imports_jax():
    """ROLE=api processes run beside the one process that owns the card, so
    building the HTTP front must not import JAX."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import main\n"
        "from rag_serving_system.core import request_queue as rq\n"
        "from rag_serving_system.config import Settings\n"
        "rq.make_queue = lambda s: rq.RequestQueue()\n"
        "app, proc, eng, _ = main.build_app("
        "settings=Settings(redis_url='redis://stub:1'), role='api')\n"
        "assert proc is None and eng is None\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'jax'))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout
