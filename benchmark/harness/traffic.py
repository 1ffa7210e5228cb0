"""The one traffic generator: every mix is a traffic/<name>.json of
parameters read here, and every request goes through the port's public
entries, lang.batch.prove_batch or lang.verify.verify.

  prove_batch  {"batch": B, "fresh": bool, "check_proofs": S}: each request
               proves B witnesses of one statement.  fresh: each request
               draws a new statement and witnesses from the seed; else one
               draw made at set-up serves every request.  S proofs, drawn
               from the seed, are held against the reference afterwards.
  verify       {"proofs": N, "tampered": T}: set-up proves N witnesses of
               one statement in one prove_batch and flips a byte of t_x in
               T of the proofs (it still parses, and costs a verifier the
               same work); requests verify them in turn.

A closed loop with one client: the next request is issued when the last
returns, while fewer than `seconds` have passed since the first was issued.
"""
import random
import time

T_X = 1 + 32 * 8            # t_x's first byte in a one-phase proof


def tamper(proof: bytes) -> bytes:
    bad = bytearray(proof)
    bad[T_X] ^= 1
    return bytes(bad)


class Request:
    __slots__ = ("index", "issued", "returned", "statement", "out", "error")

    def __init__(self, index, statement):
        self.index = index
        self.statement = statement      # (gadgets, instance, witnesses)
        self.issued = self.returned = None
        self.out = None
        self.error = None


class Traffic:
    def __init__(self, cell, seed, port, device):
        self.cell = cell
        self.params = cell.traffic
        self.kind = self.params["kind"]
        self.name = cell.config["name"]
        self.rng = random.Random(f"{cell.name}/{seed}")
        self.port = port
        self.device = device
        self.fixed = None
        self.pool = None            # verify: [(proof, coms, valid)]

    def _draw(self, batch):
        return self.cell.statement.draw(self.rng, self.cell.config, batch)

    def setup(self):
        """What the window's requests need, made before the warm-up."""
        p = self.params
        if self.kind == "prove_batch":
            if not p["fresh"]:
                self.fixed = self._draw(p["batch"])
        elif self.kind == "verify":
            self.fixed = self._draw(p["proofs"])
            gadgets, instance, witnesses = self.fixed
            out = self.port.prove_batch(self.name, instance, witnesses,
                                        gadgets, device=self.device)
            self.pool = [(proof, coms, True) for proof, _, coms in out]
            for i in range(p["tampered"]):
                proof, coms, _ = self.pool[i]
                self.pool[i] = (tamper(proof), coms, False)
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")

    def issue(self, index):
        """Run request `index` to its return -> Request (a prove_batch
        request without a fixed statement draws its own)."""
        req = Request(index, self.fixed or self._draw(self.params["batch"]))
        gadgets, instance, witnesses = req.statement
        req.issued = time.perf_counter()
        try:
            if self.kind == "prove_batch":
                req.out = self.port.prove_batch(self.name, instance,
                                                witnesses, gadgets,
                                                device=self.device)
            else:
                proof, coms, _ = self.pool[index % len(self.pool)]
                req.out = self.port.verify(self.name, instance, proof, coms,
                                           gadgets, device=self.device)
        except Exception as exc:        # a failed request is counted
            req.error = repr(exc)
        req.returned = time.perf_counter()
        return req

    def warm_up(self):
        """One request of the window's shape (verify: one of each proof)."""
        n = len(self.pool) if self.kind == "verify" else 1
        reqs = [self.issue(-1 - i) for i in range(n)]
        failed = [r.error for r in reqs if r.error]
        if failed:
            raise RuntimeError(f"warm-up request failed: {failed[0]}")

    def window(self, seconds, requests=None):
        """Closed loop for `seconds` (or exactly `requests` requests) ->
        [Request]."""
        reqs = []
        start = time.perf_counter()
        while (len(reqs) < requests if requests is not None
               else not reqs or time.perf_counter() - start < seconds):
            reqs.append(self.issue(len(reqs)))
        return reqs

    def done(self, req):
        """Units of work a request completed (proofs or verifies)."""
        if req.error is not None:
            return 0
        if self.kind == "prove_batch":
            return len(req.out)
        return 1
