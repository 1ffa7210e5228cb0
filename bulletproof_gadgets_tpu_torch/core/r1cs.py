"""R1CS constraint system: Prover and Verifier.

Protocol-compatible with bulletproofs::r1cs (dalek 2.x "yoloproofs", the
FairAds fork pinned in reference Cargo.toml:19-22).  The reference
builds all gadget constraints against this API surface
(ConstraintSystem::{multiply, allocate_multiplier, constrain, commit};
src/gadget.rs, src/cs_buffer.rs), and the single-definition /
two-interpretation property (same assemble() code for prover with
Some(assignment) and verifier with None) is preserved.

Host/Device split: this module is the *sequencing* layer — the constraint
log, Fiat-Shamir interleaving and per-phase orchestration live here.  On a
device table (ops/msm_serial.GeneratorTable, `supports_digits`) the O(n)
work runs on the device: the A_I/A_O/S digits, the flattening
(ops/flatten, host loop below its size rule), the t-poly and l(x)/r(x)
vectors (ops/prover_device), the inner-product argument (ops/ipa_fused)
and the verifier's table scalars (ops/verifier_device); the commitments'
MSM is `table.msm_digits_enc_launch` (their points compressed on the
device), the verifier's `table.msm_digits`; each reads its schedule's pool
check (ops/msm_serial.msm_digits_t's excess) in the readback it makes.  On a host table
(core/msm._HostTable) the host loops below run: they are the oracle.
`Prover.prove_gen` is the proof as a generator of device requests (the
commitments' MSM, the t-poly readback, the argument); `Prover.prove`
answers them for one proof, lang/batch for many proofs in lockstep.

The reference never uses randomized (2-phase) constraints, so this
implementation is 1-phase: A_I2/A_O2/S2 are identity and the proof
serializes with the one-phase version byte.
"""

from .scalar import Scalar, exp_iter, L as L_MOD
from .ristretto import RistrettoPoint, IDENTITY_COMPRESSED
from .lc import (Variable, LinearCombination, to_lc, ONE, COMMITTED,
                 MULT_LEFT, MULT_RIGHT, MULT_OUT)
from .transcript import (r1cs_domain_sep, r1cs_1phase_domain_sep,
                         append_point, append_scalar,
                         validate_and_append_point, challenge_scalar,
                         ProofError)
from .proof import R1CSProof
from .ipa import InnerProductProof
from .msm import msm, generator_table
from ..utils import rng


class R1CSError(Exception):
    pass


class Metrics:
    """bulletproofs::r1cs::Metrics equivalent (multipliers / constraints;
    exposed by the reference via cs.metrics(), src/cs_buffer.rs:108-110)."""

    __slots__ = ("multipliers", "constraints")

    def __init__(self, multipliers: int, constraints: int):
        self.multipliers = multipliers
        self.constraints = constraints

    def __repr__(self):
        return (f"Metrics(multipliers={self.multipliers}, "
                f"constraints={self.constraints})")


def _next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class _Poly6:
    __slots__ = ("t1", "t2", "t3", "t4", "t5", "t6")

    def __init__(self, t1, t2, t3, t4, t5, t6):
        self.t1, self.t2, self.t3, self.t4, self.t5, self.t6 = \
            t1, t2, t3, t4, t5, t6

    def eval(self, x: Scalar) -> Scalar:
        # x*(t1 + x*(t2 + x*(t3 + x*(t4 + x*(t5 + x*t6)))))
        acc = self.t6
        for t in (self.t5, self.t4, self.t3, self.t2, self.t1):
            acc = t + x * acc
        return x * acc


def _inner(a, b) -> Scalar:
    acc = Scalar.zero()
    for x, y in zip(a, b):
        acc = acc + x * y
    return acc


class Prover:
    """bulletproofs::r1cs::Prover equivalent (1-phase)."""

    def __init__(self, pc_gens, transcript):
        self.pc_gens = pc_gens
        self.transcript = transcript
        self.constraints = []   # list[LinearCombination]
        self.a_L = []           # list[Scalar]
        self.a_R = []
        self.a_O = []
        self.v = []             # committed values
        self.v_blinding = []
        r1cs_domain_sep(transcript)

    # -- metrics (FairAds fork accessors; src/prove.rs:75,78) --------------
    def num_constraints(self) -> int:
        return len(self.constraints)

    def get_num_multiplications(self) -> int:
        return len(self.a_L)

    def metrics(self) -> "Metrics":
        return Metrics(len(self.a_L), len(self.constraints))

    # -- high-level variables ---------------------------------------------
    def commit(self, v: Scalar, v_blinding: Scalar):
        i = len(self.v)
        self.v.append(v)
        self.v_blinding.append(v_blinding)
        V = self.pc_gens.commit(v, v_blinding).compress()
        append_point(self.transcript, b"V", V)
        return V, Variable(COMMITTED, i)

    # -- ConstraintSystem -------------------------------------------------
    def eval(self, lc: LinearCombination) -> Scalar:
        acc = Scalar.zero()
        for var, coeff in lc.terms:
            if var.kind == ONE:
                acc = acc + coeff
            elif var.kind == COMMITTED:
                acc = acc + coeff * self.v[var.index]
            elif var.kind == MULT_LEFT:
                acc = acc + coeff * self.a_L[var.index]
            elif var.kind == MULT_RIGHT:
                acc = acc + coeff * self.a_R[var.index]
            else:
                acc = acc + coeff * self.a_O[var.index]
        return acc

    def multiply(self, left, right):
        left = to_lc(left).clone()
        right = to_lc(right).clone()
        l = self.eval(left)
        r = self.eval(right)
        o = l * r
        i = len(self.a_L)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(o)
        l_var = Variable(MULT_LEFT, i)
        r_var = Variable(MULT_RIGHT, i)
        o_var = Variable(MULT_OUT, i)
        # Constrain l_var == left, r_var == right (dalek does this inline).
        left.terms.append((l_var, -Scalar.one()))
        right.terms.append((r_var, -Scalar.one()))
        self.constrain(left)
        self.constrain(right)
        return l_var, r_var, o_var

    def allocate_multiplier(self, assignment, _bit_source=None):
        if assignment is None:
            raise R1CSError("missing assignment")
        l, r = assignment
        i = len(self.a_L)
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(l * r)
        return (Variable(MULT_LEFT, i), Variable(MULT_RIGHT, i),
                Variable(MULT_OUT, i))

    def constrain(self, lc):
        self.constraints.append(to_lc(lc))

    # -- flattening --------------------------------------------------------
    def _flattened_constraints(self, z: Scalar):
        """Returns (wL, wR, wO, wV) as raw ints (not Scalars): this loop
        touches every constraint term, so it runs on deferred-mod Python
        ints (one mul + one add per term; reduced on exit)."""
        n = len(self.a_L)
        m = len(self.v)
        wL = [0] * n
        wR = [0] * n
        wO = [0] * n
        wV = [0] * m
        exp_z = z.v % L_MOD
        for lc in self.constraints:
            for var, coeff in lc.terms:
                c = exp_z * coeff.v
                if var.kind == MULT_LEFT:
                    wL[var.index] += c
                elif var.kind == MULT_RIGHT:
                    wR[var.index] += c
                elif var.kind == MULT_OUT:
                    wO[var.index] += c
                elif var.kind == COMMITTED:
                    wV[var.index] -= c
                # One(): not needed on the prover side
            exp_z = exp_z * z.v % L_MOD
        return ([x % L_MOD for x in wL], [x % L_MOD for x in wR],
                [x % L_MOD for x in wO], [x % L_MOD for x in wV])

    # -- proving -----------------------------------------------------------
    def prove(self, bp_gens) -> R1CSProof:
        """Single proof: drives `prove_gen`, answering each request with
        the table itself (`table.msm_digits_enc_launch` / `_finish`), one
        readback, or ops/ipa_fused.create."""
        gen = self.prove_gen(bp_gens)
        resp = None
        while True:
            try:
                kind, table, arg = gen.send(resp)
            except StopIteration as stop:
                return stop.value
            if kind == "msm_enc":
                resp = table.msm_digits_enc_finish(
                    table.msm_digits_enc_launch(arg))
            elif kind == "fused_ipa":
                from ..ops import ipa_fused
                resp = ipa_fused.create(arg[0], table, *arg[1:])
            else:
                assert kind == "fetch"
                resp = arg.cpu()

    def prove_gen(self, bp_gens):
        """Generator form of prove().  On a device table (`supports_digits`)
        the O(n) vectors stay on the device and it yields, in order:
          ("msm_enc", table, digits)  the A_I/A_O/S commitments' device
                                      digits [3*32, m]; expects their 3
                                      encodings (compressed on the
                                      device, one readback of 96 bytes);
          ("fetch", None, rows)       the t-poly inner products [9, NW];
                                      expects them on the host;
          ("fused_ipa", table, args)  the argument (core/ipa.create_gen);
                                      expects (L_vec, R_vec, a0, b0).
        The commitments' request comes after the draws of their blindings
        and s_L, s_R, and before the draws of the t blindings, as in the
        JAX package, so lang.batch's lockstep draws every proof's
        commitment blindings first.  On a host table it yields nothing:
        every table MSM is one `table.msm_many` over the stacked vectors."""
        t = self.transcript
        t.append_u64(b"m", len(self.v))

        n1 = len(self.a_L)
        if bp_gens.gens_capacity < n1:
            raise R1CSError("invalid generators length")
        padded_n1 = _next_pow2(n1)
        if bp_gens.gens_capacity < padded_n1:
            raise R1CSError("invalid generators length")

        # Device-resident [G | H | B | B_blinding] table sized to the padded
        # circuit: points upload once; every prover MSM from here on (the
        # three vector commitments below and all IPA L/R pairs) is a scalar
        # vector over this table, batched into shared launches.
        G_pad = bp_gens.G(padded_n1)
        H_pad = bp_gens.H(padded_n1)
        table = generator_table(G_pad, H_pad,
                                self.pc_gens.B, self.pc_gens.B_blinding)

        i_blinding1 = rng.random_scalar()
        o_blinding1 = rng.random_scalar()
        s_blinding1 = rng.random_scalar()
        s_L1 = rng.random_scalars(n1)
        s_R1 = rng.random_scalars(n1)

        device = getattr(table, "supports_digits", False)
        if device:
            # one upload of the five vectors; the digits recode on device
            from ..ops import prover_device
            dev = table.src.device
            wit = prover_device.upload(
                [[s.v for s in vec] for vec in
                 (self.a_L, self.a_R, self.a_O, s_L1, s_R1)], dev)
            # the three points compress on the device: 96 bytes come back
            A_I1, A_O1, S1 = yield ("msm_enc", table,
                                    prover_device.commitment_digits(
                                        *wit, (i_blinding1.v, o_blinding1.v,
                                               s_blinding1.v), padded_n1))
        else:
            zpad = [0] * (padded_n1 - n1)
            zeros_N = [0] * padded_n1
            v_AI = ([s.v for s in self.a_L] + zpad
                    + [s.v for s in self.a_R] + zpad + [0, i_blinding1.v])
            v_AO = ([s.v for s in self.a_O] + zpad
                    + zeros_N + [0, o_blinding1.v])
            v_S = ([s.v for s in s_L1] + zpad
                   + [s.v for s in s_R1] + zpad + [0, s_blinding1.v])
            p_AI, p_AO, p_S = table.msm_many([v_AI, v_AO, v_S])
            A_I1 = p_AI.compress()
            A_O1 = p_AO.compress()
            S1 = p_S.compress()

        append_point(t, b"A_I1", A_I1)
        append_point(t, b"A_O1", A_O1)
        append_point(t, b"S1", S1)

        # 1-phase circuit: no deferred constraint callbacks (the reference
        # never registers any), phase-2 commitments are the identity.
        r1cs_1phase_domain_sep(t)
        n = len(self.a_L)
        n2 = n - n1
        assert n2 == 0
        i_blinding2 = o_blinding2 = s_blinding2 = Scalar.zero()
        A_I2 = A_O2 = S2 = IDENTITY_COMPRESSED

        padded_n = _next_pow2(n)
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise R1CSError("invalid generators length")

        append_point(t, b"A_I2", A_I2)
        append_point(t, b"A_O2", A_O2)
        append_point(t, b"S2", S2)

        y = challenge_scalar(t, b"y")
        z = challenge_scalar(t, b"z")

        y_inv = y.invert()

        flat = None
        if device:
            from ..ops.flatten import flatten
            flat = flatten(self.constraints, n, len(self.v), z.v % L_MOD,
                           False, dev)
        if flat is not None:
            wL, wR, wO, wV = flat.wL, flat.wR, flat.wO, flat.wV
        else:
            wL, wR, wO, wV = self._flattened_constraints(z)

        if device:
            # the O(n) polynomial vectors on the device; l/r stay there
            pv = prover_device.ProverVectors(
                *wit, wL, wR, wO, y.v % L_MOD, y_inv.v % L_MOD, padded_n,
                dev)
            t_parts = yield ("fetch", None, pv.t_poly_device())
            t_poly = _Poly6(*(Scalar(v) for v in pv.t_poly_from(t_parts)))
        else:
            exp_y_vec = exp_iter(y, max(n, 1))
            exp_y_inv = exp_iter(y_inv, padded_n)
            wLs = [Scalar(v) for v in wL]
            wRs = [Scalar(v) for v in wR]
            wOs = [Scalar(v) for v in wO]

            l1 = [self.a_L[i] + exp_y_inv[i] * wRs[i] for i in range(n)]
            l2 = list(self.a_O)
            l3 = list(s_L1)
            r0 = [wOs[i] - exp_y_vec[i] for i in range(n)]
            r1 = [exp_y_vec[i] * self.a_R[i] + wLs[i] for i in range(n)]
            r3 = [exp_y_vec[i] * s_R1[i] for i in range(n)]

            t_poly = _Poly6(
                _inner(l1, r0),
                _inner(l1, r1) + _inner(l2, r0),
                _inner(l2, r1) + _inner(l3, r0),
                _inner(l1, r3) + _inner(l3, r1),
                _inner(l2, r3),
                _inner(l3, r3),
            )

        t_1_blinding = rng.random_scalar()
        t_3_blinding = rng.random_scalar()
        t_4_blinding = rng.random_scalar()
        t_5_blinding = rng.random_scalar()
        t_6_blinding = rng.random_scalar()

        T_1 = self.pc_gens.commit(t_poly.t1, t_1_blinding).compress()
        T_3 = self.pc_gens.commit(t_poly.t3, t_3_blinding).compress()
        T_4 = self.pc_gens.commit(t_poly.t4, t_4_blinding).compress()
        T_5 = self.pc_gens.commit(t_poly.t5, t_5_blinding).compress()
        T_6 = self.pc_gens.commit(t_poly.t6, t_6_blinding).compress()

        append_point(t, b"T_1", T_1)
        append_point(t, b"T_3", T_3)
        append_point(t, b"T_4", T_4)
        append_point(t, b"T_5", T_5)
        append_point(t, b"T_6", T_6)

        u = challenge_scalar(t, b"u")
        x = challenge_scalar(t, b"x")

        t_2_blinding = _inner([Scalar(v) for v in wV], self.v_blinding)
        t_blinding_poly = _Poly6(t_1_blinding, t_2_blinding, t_3_blinding,
                                 t_4_blinding, t_5_blinding, t_6_blinding)

        t_x = t_poly.eval(x)
        t_x_blinding = t_blinding_poly.eval(x)

        xx = x * x
        xxx = xx * x
        if device:
            l_vec, r_vec = pv.lr(x.v % L_MOD)     # device [padded_n, NW]
        else:
            l_vec = [l1[i] * x + l2[i] * xx + l3[i] * xxx for i in range(n)]
            l_vec += [Scalar.zero()] * pad
            r_vec = [r0[i] + r1[i] * x + r3[i] * xxx for i in range(n)]
            exp_y_pad = exp_iter(y, padded_n + 1)
            for i in range(n, padded_n):
                r_vec.append(-exp_y_pad[i])

        i_blinding = i_blinding1 + u * i_blinding2
        o_blinding = o_blinding1 + u * o_blinding2
        s_blinding = s_blinding1 + u * s_blinding2
        e_blinding = x * (i_blinding + x * (o_blinding + x * s_blinding))

        append_scalar(t, b"t_x", t_x)
        append_scalar(t, b"t_x_blinding", t_x_blinding)
        append_scalar(t, b"e_blinding", e_blinding)

        w = challenge_scalar(t, b"w")
        Q = self.pc_gens.B.scalar_mul(w.v)

        if device:
            G_factors, H_factors = pv.factors(n1, u.v % L_MOD)
        else:
            G_factors = ([Scalar.one()] * n1 + [u] * (n2 + pad))
            H_factors = [exp_y_inv[i] * G_factors[i]
                         for i in range(padded_n)]

        assert padded_n == padded_n1
        ipp = yield from InnerProductProof.create_gen(
            t, Q, G_factors, H_factors,
            list(bp_gens.G(padded_n)), list(bp_gens.H(padded_n)),
            l_vec, r_vec, table=table, w=w)

        return R1CSProof(A_I1, A_O1, S1, A_I2, A_O2, S2,
                         T_1, T_3, T_4, T_5, T_6,
                         t_x, t_x_blinding, e_blinding, ipp)


class Verifier:
    """bulletproofs::r1cs::Verifier equivalent (1-phase)."""

    def __init__(self, transcript):
        self.transcript = transcript
        self.constraints = []
        self.num_vars = 0       # multiplier count
        self.V = []             # compressed commitments
        r1cs_domain_sep(transcript)

    def get_num_vars(self) -> int:
        return self.num_vars

    def metrics(self) -> "Metrics":
        return Metrics(self.num_vars, len(self.constraints))

    def num_constraints(self) -> int:
        return len(self.constraints)

    def commit(self, commitment: bytes) -> Variable:
        i = len(self.V)
        self.V.append(commitment)
        append_point(self.transcript, b"V", commitment)
        return Variable(COMMITTED, i)

    def multiply(self, left, right):
        left = to_lc(left).clone()
        right = to_lc(right).clone()
        i = self.num_vars
        self.num_vars += 1
        l_var = Variable(MULT_LEFT, i)
        r_var = Variable(MULT_RIGHT, i)
        o_var = Variable(MULT_OUT, i)
        left.terms.append((l_var, -Scalar.one()))
        right.terms.append((r_var, -Scalar.one()))
        self.constrain(left)
        self.constrain(right)
        return l_var, r_var, o_var

    def allocate_multiplier(self, _assignment=None, _bit_source=None):
        i = self.num_vars
        self.num_vars += 1
        return (Variable(MULT_LEFT, i), Variable(MULT_RIGHT, i),
                Variable(MULT_OUT, i))

    def constrain(self, lc):
        self.constraints.append(to_lc(lc))

    def _flattened_constraints(self, z: Scalar):
        """(wL, wR, wO, wV, wc) as raw ints (deferred-mod; see Prover)."""
        n = self.num_vars
        m = len(self.V)
        wL = [0] * n
        wR = [0] * n
        wO = [0] * n
        wV = [0] * m
        wc = 0
        exp_z = z.v % L_MOD
        for lc in self.constraints:
            for var, coeff in lc.terms:
                c = exp_z * coeff.v
                if var.kind == MULT_LEFT:
                    wL[var.index] += c
                elif var.kind == MULT_RIGHT:
                    wR[var.index] += c
                elif var.kind == MULT_OUT:
                    wO[var.index] += c
                elif var.kind == COMMITTED:
                    wV[var.index] -= c
                else:  # One()
                    wc -= c
            exp_z = exp_z * z.v % L_MOD
        return ([x % L_MOD for x in wL], [x % L_MOD for x in wR],
                [x % L_MOD for x in wO], [x % L_MOD for x in wV],
                wc % L_MOD)

    def verify(self, proof: R1CSProof, pc_gens, bp_gens) -> None:
        """Raises R1CSError / ProofError on failure (mirrors Err paths)."""
        t = self.transcript
        t.append_u64(b"m", len(self.V))

        n1 = self.num_vars
        validate_and_append_point(t, b"A_I1", proof.A_I1)
        validate_and_append_point(t, b"A_O1", proof.A_O1)
        validate_and_append_point(t, b"S1", proof.S1)

        r1cs_1phase_domain_sep(t)
        n = self.num_vars
        n2 = n - n1
        padded_n = _next_pow2(n)
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise R1CSError("invalid generators length")

        append_point(t, b"A_I2", proof.A_I2)
        append_point(t, b"A_O2", proof.A_O2)
        append_point(t, b"S2", proof.S2)

        y = challenge_scalar(t, b"y")
        z = challenge_scalar(t, b"z")

        validate_and_append_point(t, b"T_1", proof.T_1)
        validate_and_append_point(t, b"T_3", proof.T_3)
        validate_and_append_point(t, b"T_4", proof.T_4)
        validate_and_append_point(t, b"T_5", proof.T_5)
        validate_and_append_point(t, b"T_6", proof.T_6)

        u = challenge_scalar(t, b"u")
        x = challenge_scalar(t, b"x")

        append_scalar(t, b"t_x", proof.t_x)
        append_scalar(t, b"t_x_blinding", proof.t_x_blinding)
        append_scalar(t, b"e_blinding", proof.e_blinding)

        w = challenge_scalar(t, b"w")

        a = proof.ipp_proof.a
        b = proof.ipp_proof.b
        y_inv = y.invert()

        r = rng.random_scalar()
        xx = x * x
        rxx = r * xx
        xxx = x * xx

        T_scalars = [r * x, r * xxx, r * x * xxx, r * xx * xxx,
                     r * xxx * xxx]
        T_points = [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6]

        def decompress(bts):
            p = RistrettoPoint.decompress(bts)
            if p is None:
                raise ProofError("invalid point encoding")
            return p

        # Split the mega-MSM: the bulk rides the device-resident
        # [G | H | B | B_blinding] table (same table object the prover used —
        # no per-verify point upload, one cached kernel shape per size);
        # only the O(m + log n) proof-dependent points go through a small
        # dynamic MSM.
        table = generator_table(bp_gens.G(padded_n), bp_gens.H(padded_n),
                                pc_gens.B, pc_gens.B_blinding)
        if getattr(table, "supports_digits", False):
            # the O(n) scalars on the device (ops/verifier_device); the host
            # computes only delta and the two B-slot coefficients
            from ..ops import fl, flvec, verifier_device
            from ..ops.flatten import flatten
            dev = table.src.device
            u_sq, u_inv_sq, allinv = \
                proof.ipp_proof.verification_challenges(padded_n, t)
            flat = flatten(self.constraints, n, len(self.V), z.v % L_MOD,
                           True, dev)
            if flat is not None:
                wL_d, wR_d, wO_d = flat.wL, flat.wR, flat.wO
                wV, wc = flat.wV, flat.wc
            else:
                wL, wR, wO, wV, wc = self._flattened_constraints(z)
                wL_d, wR_d, wO_d = fl.to_limbs(wL + wR + wO, dev).view(
                    3, n, fl.NW).unbind(0)
            yinv_m = flvec.powers_mont(y_inv.v % L_MOD, padded_n, dev)
            ynw_d = fl.mont_mul(wR_d, yinv_m[:n])
            delta = fl.limbs_to_ints(flvec.inner(ynw_d, wL_d))[0]
            c_B = (w.v * (proof.t_x.v - a.v * b.v)
                   + r.v * (xx.v * (wc + delta) - proof.t_x.v)) % L_MOD
            c_Bb = (-proof.e_blinding.v - r.v * proof.t_x_blinding.v) % L_MOD
            (table_part,) = table.msm_digits(verifier_device.table_digits_dev(
                ynw_d, wL_d, wO_d, yinv_m, x.v, a.v, b.v, u.v, allinv.v,
                [v.v for v in u_sq], n, n1, padded_n, c_B, c_Bb))
        else:
            wL, wR, wO, wV, wc = self._flattened_constraints(z)
            u_sq, u_inv_sq, s = \
                proof.ipp_proof.verification_scalars(padded_n, t)
            y_inv_vec = exp_iter(y_inv, padded_n)
            wLs = [Scalar(v) for v in wL]
            wRs = [Scalar(v) for v in wR]
            wOs = [Scalar(v) for v in wO]
            yneg_wR = [wRs[i] * y_inv_vec[i] for i in range(n)] + \
                      [Scalar.zero()] * pad

            delta_s = _inner(yneg_wR[:n], wLs)

            u_or_1 = [Scalar.one()] * n1 + [u] * (n2 + pad)

            g_scalars = [u_or_1[i] * (x * yneg_wR[i] - a * s[i])
                         for i in range(padded_n)]
            s_rev = list(reversed(s))
            wL_pad = wLs + [Scalar.zero()] * pad
            wO_pad = wOs + [Scalar.zero()] * pad
            h_scalars = [
                u_or_1[i] * (y_inv_vec[i] * (x * wL_pad[i] + wO_pad[i]
                                             - b * s_rev[i]) - Scalar.one())
                for i in range(padded_n)]

            table_vec = ([sc.v for sc in g_scalars]
                         + [sc.v for sc in h_scalars]
                         + [(w * (proof.t_x - a * b)
                             + r * (xx * (Scalar(wc) + delta_s)
                                    - proof.t_x)).v]
                         + [(-proof.e_blinding
                             - r * proof.t_x_blinding).v])
            (table_part,) = table.msm_many([table_vec])

        dyn_scalars = ([x, xx, xxx, u * x, u * xx, u * xxx]
                       + [Scalar(wVi) * rxx for wVi in wV]
                       + T_scalars
                       + u_sq
                       + u_inv_sq)
        dyn_points = ([decompress(proof.A_I1), decompress(proof.A_O1),
                       decompress(proof.S1), decompress(proof.A_I2),
                       decompress(proof.A_O2), decompress(proof.S2)]
                      + [decompress(Vb) for Vb in self.V]
                      + [decompress(Tb) for Tb in T_points]
                      + [decompress(Lb) for Lb in proof.ipp_proof.L_vec]
                      + [decompress(Rb) for Rb in proof.ipp_proof.R_vec])

        mega_check = table_part + msm(dyn_scalars, dyn_points)
        if not (mega_check == RistrettoPoint.identity()):
            raise R1CSError("verification error")
