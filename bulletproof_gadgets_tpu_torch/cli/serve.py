"""Proof service: a minimal HTTP API over the prover/verifier.

The reference exposes prove/verify to applications through JNI and a C ABI
(interfaces/android, interfaces/ios; the port has both too, capi/).  A
service endpoint is the other embedding: statements come in over HTTP, the
GPU does the math, artifacts go back — suitable for serving behind a load
balancer, one process per GPU.

POST /prove   {"name": ..., "instance": ..., "witness": ..., "gadgets": ...}
           -> {"proof": hex, "commitments": ..., "constraints": N}
POST /verify  {"name": ..., "instance": ..., "proof": hex,
               "commitments": ..., "gadgets": ...}
           -> {"verified": true|false}

Usage: python -m bulletproof_gadgets_tpu_torch.cli.serve [port]

The device comes from BPG_TORCH_DEVICE (default "cuda") and is registered
before the server starts, so a machine without CUDA fails at start, not at
the first request.
"""
import json
import os
import sys
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from threading import Lock

# the engine, the generator and template caches and the blinding stream
# are global to the process: one request at a time
_lock = Lock()


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        sys.stderr.write("[serve] " + fmt % args + "\n")

    def _reply(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        from ..lang.prove import prove
        from ..lang.verify import verify

        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length))
        except (ValueError, json.JSONDecodeError):
            return self._reply(400, {"error": "malformed request"})

        try:
            if self.path == "/prove":
                coms = []
                with _lock:
                    proof, n = prove(req["name"], req["instance"],
                                     req["witness"], req["gadgets"], coms)
                return self._reply(200, {
                    "proof": proof.hex(),
                    "commitments": "".join(coms),
                    "constraints": n,
                })
            if self.path == "/verify":
                with _lock:
                    ok = verify(req["name"], req["instance"],
                                bytes.fromhex(req["proof"]),
                                req["commitments"], req["gadgets"])
                return self._reply(200, {"verified": ok})
            return self._reply(404, {"error": "unknown endpoint"})
        except KeyError as e:
            return self._reply(400, {"error": f"missing field {e}"})
        except Exception as e:  # proof errors -> client-visible message
            traceback.print_exc()
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    port = int(argv[0]) if argv else 8399
    from ..ops import engine
    device = engine.use(os.environ.get("BPG_TORCH_DEVICE", "cuda"))
    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"bulletproof_gadgets_tpu_torch proof service on 127.0.0.1:{port} "
          f"({device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
