"""Radix-2 evaluation domain over Fr — pure-Python oracle.

Mirrors arkworks `Radix2EvaluationDomain` semantics as used by the reference
(`plonk-core/lib/PLONK/src/domain.cu:3-97`, ark-poly):
  - fft / ifft with natural-order outputs,
  - coset_fft / coset_ifft over g*H with g = Fr multiplicative generator (7),
  - vanishing-polynomial evaluation, element access.
"""

from ..params import R_MOD, FR_GENERATOR
from .field import root_of_unity, fr_batch_inv


class Domain:
    def __init__(self, n: int):
        assert n & (n - 1) == 0 and n > 0, "domain size must be a power of two"
        self.n = n
        self.log_n = n.bit_length() - 1
        self.omega = root_of_unity(self.log_n)
        self.omega_inv = pow(self.omega, -1, R_MOD)
        self.n_inv = pow(n, -1, R_MOD)
        self.coset_gen = FR_GENERATOR
        self.coset_gen_inv = pow(FR_GENERATOR, -1, R_MOD)

    def element(self, i: int) -> int:
        return pow(self.omega, i, R_MOD)

    def elements(self):
        w, x = self.omega, 1
        for _ in range(self.n):
            yield x
            x = x * w % R_MOD

    def _fft_in_place(self, a, omega):
        """Iterative Cooley-Tukey NTT, natural order in/out."""
        n = len(a)
        # bit-reversal permutation
        j = 0
        for i in range(1, n):
            bit = n >> 1
            while j & bit:
                j ^= bit
                bit >>= 1
            j |= bit
            if i < j:
                a[i], a[j] = a[j], a[i]
        length = 2
        while length <= n:
            w_len = pow(omega, n // length, R_MOD)
            for start in range(0, n, length):
                w = 1
                half = length >> 1
                for k in range(start, start + half):
                    u = a[k]
                    v = a[k + half] * w % R_MOD
                    a[k] = (u + v) % R_MOD
                    a[k + half] = (u - v) % R_MOD
                    w = w * w_len % R_MOD
            length <<= 1
        return a

    def fft(self, coeffs):
        a = list(coeffs)[: self.n] + [0] * max(0, self.n - len(coeffs))
        return self._fft_in_place(a, self.omega)

    def ifft(self, evals):
        a = list(evals)[: self.n] + [0] * max(0, self.n - len(evals))
        a = self._fft_in_place(a, self.omega_inv)
        return [x * self.n_inv % R_MOD for x in a]

    def coset_fft(self, coeffs):
        """Evaluate poly over the coset g*H (distribute powers then fft)."""
        a = list(coeffs)[: self.n] + [0] * max(0, self.n - len(coeffs))
        g, gp = self.coset_gen, 1
        for i in range(self.n):
            a[i] = a[i] * gp % R_MOD
            gp = gp * g % R_MOD
        return self._fft_in_place(a, self.omega)

    def coset_ifft(self, evals):
        a = self.ifft(evals)
        g, gp = self.coset_gen_inv, 1
        for i in range(self.n):
            a[i] = a[i] * gp % R_MOD
            gp = gp * g % R_MOD
        return a

    def evaluate_vanishing_polynomial(self, tau: int) -> int:
        return (pow(tau, self.n, R_MOD) - 1) % R_MOD

    def evaluate_all_lagrange_coefficients(self, tau: int):
        """L_i(tau) for all i (matches ark-poly semantics)."""
        z = self.evaluate_vanishing_polynomial(tau)
        if z == 0:
            # tau is in the domain: indicator vector
            out = [0] * self.n
            w = 1
            for i in range(self.n):
                if w == tau:
                    out[i] = 1
                w = w * self.omega % R_MOD
            return out
        # L_i(tau) = (z / n) * (omega^i / (tau - omega^i))
        zn = z * self.n_inv % R_MOD
        denoms = []
        w = 1
        for i in range(self.n):
            denoms.append((tau - w) % R_MOD)
            w = w * self.omega % R_MOD
        invs = fr_batch_inv(denoms)
        out = []
        w = 1
        for i in range(self.n):
            out.append(zn * w % R_MOD * invs[i] % R_MOD)
            w = w * self.omega % R_MOD
        return out


def poly_eval(coeffs, x):
    """Horner evaluation of a dense polynomial at x (mod r)."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R_MOD
    return acc


def poly_mul_scalar(coeffs, s):
    return [c * s % R_MOD for c in coeffs]


def poly_add(a, b):
    n = max(len(a), len(b))
    a = list(a) + [0] * (n - len(a))
    b = list(b) + [0] * (n - len(b))
    return [(x + y) % R_MOD for x, y in zip(a, b)]


def poly_divide_linear(coeffs, z):
    """Synthetic division: returns q with p(X) = q(X)(X - z) + p(z).

    Oracle for the GPU `poly_div_poly` log-step kernel
    (`lib/PLONK/utils/mont/cuda/mont_arithmetic.cu:305-331`).
    """
    n = len(coeffs)
    if n == 0:
        return []
    q = [0] * (n - 1)
    acc = 0
    for i in range(n - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % R_MOD
        q[i - 1] = acc
    return q
