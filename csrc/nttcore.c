/* nttcore — native host-side NTT core (golden model + table generation).
 *
 * The reference is 100% native (DPC++/C++17, SURVEY.md §2); this library is
 * this library's native runtime component: a third, independent
 * implementation of the Harvey lazy negacyclic NTT used to generate and
 * cross-check large SEAL-Embedded-style test-vector batteries at C speed,
 * plus prime search / primitive-root / twiddle-table generation.
 *
 * The arithmetic mirrors the reference compute kernel exactly:
 *   - Shoup mulmod via the high 64 bits of a 64x64 product
 *     (/root/reference/src/kernel/ntt.cpp:346-363 synthesizes this from
 *     32x32 partials; here __uint128_t does it directly)
 *   - lazy values in [0, 4q), conditional -2q reduction (ntt.cpp:331-332)
 *   - X' = tx + Q, X_t' = tx + 2q - Q (ntt.cpp:368-369)
 *   - final-stage correction to [0, q) (ntt.cpp:377-394)
 *
 * Exposed with a plain C ABI for ctypes (no pybind11 in this toolchain).
 * Build: make native   (gcc -O3 -shared -fPIC)
 */

#include <stdint.h>
#include <stddef.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

static inline u64 mulmod_u64(u64 a, u64 b, u64 q) {
    return (u64)(((u128)a * b) % q);
}

static inline u64 powmod_u64(u64 base, u64 exp, u64 q) {
    u64 r = 1 % q;
    base %= q;
    while (exp) {
        if (exp & 1) r = mulmod_u64(r, base, q);
        base = mulmod_u64(base, base, q);
        exp >>= 1;
    }
    return r;
}

static inline u64 mulhi_u64(u64 a, u64 b) {
    return (u64)(((u128)a * b) >> 64);
}

/* ------------------------------------------------------------------ */
/* primality / roots                                                   */
/* ------------------------------------------------------------------ */

static int miller_rabin_once(u64 n, u64 a, u64 d, int r) {
    u64 x = powmod_u64(a, d, n);
    if (x == 1 || x == n - 1) return 1;
    for (int i = 0; i < r - 1; i++) {
        x = mulmod_u64(x, x, n);
        if (x == n - 1) return 1;
    }
    return 0;
}

int ntt_is_prime(u64 n) {
    if (n < 2) return 0;
    static const u64 small[] = {2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37};
    for (size_t i = 0; i < sizeof(small) / sizeof(small[0]); i++) {
        if (n % small[i] == 0) return n == small[i];
    }
    u64 d = n - 1;
    int r = 0;
    while ((d & 1) == 0) { d >>= 1; r++; }
    /* deterministic for n < 3.3e24 */
    for (size_t i = 0; i < sizeof(small) / sizeof(small[0]); i++) {
        if (!miller_rabin_once(n, small[i], d, r)) return 0;
    }
    return 1;
}

/* Find `count` primes q ≡ 1 (mod 2n), q < 2^bits, descending.
 * Returns number found. */
int ntt_find_primes(u64 n, int count, int bits, u64* out) {
    u64 m = 2 * n;
    u64 q = (((u64)1 << bits) - 1) / m * m + 1;
    int found = 0;
    while (found < count && q > m) {
        if (ntt_is_prime(q)) out[found++] = q;
        q -= m;
    }
    return found;
}

static u64 bit_reverse_u64(u64 x, int bits) {
    u64 r = 0;
    for (int i = 0; i < bits; i++) { r = (r << 1) | (x & 1); x >>= 1; }
    return r;
}

/* Smallest-generator primitive 2n-th root of unity (psi^n == -1 mod q). */
u64 ntt_find_psi(u64 n, u64 q) {
    u64 phi = q - 1;
    /* factor phi (small trial division is fine for 30-bit primes) */
    u64 factors[64];
    int nf = 0;
    u64 tmp = phi;
    for (u64 d = 2; d * d <= tmp; d++) {
        if (tmp % d == 0) {
            factors[nf++] = d;
            while (tmp % d == 0) tmp /= d;
        }
    }
    if (tmp > 1) factors[nf++] = tmp;
    u64 g = 2;
    for (;; g++) {
        int ok = 1;
        for (int i = 0; i < nf; i++) {
            if (powmod_u64(g, phi / factors[i], q) == 1) { ok = 0; break; }
        }
        if (ok) break;
    }
    u64 psi = powmod_u64(g, phi / (2 * n), q);
    /* reject invalid parameters (q not prime, or 2n does not divide q-1):
     * psi must satisfy psi^n == -1 or every downstream table is garbage —
     * the dummy-twiddle failure mode of the reference driver */
    if (powmod_u64(psi, n, q) != q - 1) return 0;
    return psi;
}

/* roots[i] = psi^bitrev(i, log2 n); precons[i] = floor(roots[i] * 2^64 / q).
 * Same table layout the reference kernel consumes (ntt.cpp:298-300). */
void ntt_make_tables(u64 n, u64 q, u64 psi, u64* roots, u64* precons) {
    int logn = 0;
    while (((u64)1 << logn) < n) logn++;
    for (u64 i = 0; i < n; i++) {
        u64 w = powmod_u64(psi, bit_reverse_u64(i, logn), q);
        roots[i] = w;
        precons[i] = (u64)((((u128)w) << 64) / q);
    }
}

/* ------------------------------------------------------------------ */
/* transforms (in-place over a batch of polynomials)                   */
/* ------------------------------------------------------------------ */

/* Forward negacyclic NTT, Harvey lazy, output reduced to [0, q).
 * data: batch x n, row-major, modified in place. */
void ntt_fwd_u64(u64* data, u64 batch, u64 n, u64 q,
                 const u64* roots, const u64* precons) {
    u64 two_q = q << 1;
    for (u64 b = 0; b < batch; b++) {
        u64* a = data + b * n;
        u64 t = n >> 1;
        for (u64 m = 1; m < n; m <<= 1) {
            int last = (m == (n >> 1));
            for (u64 i = 0; i < m; i++) {
                u64 j1 = 2 * i * t;
                u64 W = roots[m + i];
                u64 Wp = precons[m + i];
                for (u64 j = j1; j < j1 + t; j++) {
                    u64 tx = a[j];
                    if (tx >= two_q) tx -= two_q;
                    u64 ay = a[j + t];
                    u64 Q = W * ay - mulhi_u64(ay, Wp) * q;
                    u64 u = tx + Q;
                    u64 v = tx + two_q - Q;
                    if (last) {
                        if (u >= two_q) u -= two_q;
                        if (u >= q) u -= q;
                        if (v >= two_q) v -= two_q;
                        if (v >= q) v -= q;
                    }
                    a[j] = u;
                    a[j + t] = v;
                }
            }
            t >>= 1;
        }
    }
}

/* Inverse negacyclic NTT (Gentleman-Sande, stages reversed), scaled by
 * n^-1 (or `scale` if nonzero), output reduced to [0, q).
 * iroots/iprecons: elementwise inverses of the forward tables, same index. */
void ntt_inv_u64(u64* data, u64 batch, u64 n, u64 q,
                 const u64* iroots, const u64* iprecons, u64 scale) {
    u64 two_q = q << 1;
    if (scale == 0) scale = powmod_u64(n % q, q - 2, q);
    u64 scale_pre = (u64)((((u128)scale) << 64) / q);
    for (u64 b = 0; b < batch; b++) {
        u64* a = data + b * n;
        u64 t = 1;
        for (u64 m = n >> 1; m >= 1; m >>= 1) {
            for (u64 i = 0; i < m; i++) {
                u64 j1 = 2 * i * t;
                u64 W = iroots[m + i];
                u64 Wp = iprecons[m + i];
                for (u64 j = j1; j < j1 + t; j++) {
                    u64 x = a[j];
                    u64 y = a[j + t];
                    u64 s = x + y;
                    if (s >= two_q) s -= two_q;
                    u64 d = x + two_q - y;
                    a[j] = s;
                    a[j + t] = W * d - mulhi_u64(d, Wp) * q;
                }
            }
            t <<= 1;
        }
        for (u64 j = 0; j < n; j++) {
            u64 v = scale * a[j] - mulhi_u64(a[j], scale_pre) * q;
            if (v >= q) v -= q;
            a[j] = v;
        }
    }
}

/* Pointwise c = a*b mod q over a batch (for polymul vector generation). */
void ntt_pointwise_u64(const u64* a, const u64* b, u64* c, u64 len, u64 q) {
    for (u64 i = 0; i < len; i++) c[i] = mulmod_u64(a[i], b[i], q);
}

int ntt_core_version(void) { return 1; }
