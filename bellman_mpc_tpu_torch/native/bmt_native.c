/* bmt_native — C-ABI host runtime kernels for bellman_mpc_tpu.
 *
 * The TPU owns the field/curve/NTT/MSM/pairing compute; what remains hot on
 * the host is per-proof witness processing: evaluating every constraint's
 * A/B/C linear combinations against the assignment (the reference does this
 * in Rust: bellman/src/groth16/prover.rs:19-53 inside synthesis).  This file
 * implements that sparse evaluation over 256-bit scalars with unreduced
 * 576-bit accumulation (the single modular reduction per value happens on
 * the Python side with native bigints).
 *
 * Also exports the reference's C-ABI surface names (bellman/src/lib.rs:
 * 156-201): test_bellman and process.
 *
 * Build: cc -O3 -shared -fPIC bmt_native.c -o libbmt_native.so
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;

/* acc (9 x u64, little-endian) += a (4 limbs) * b (4 limbs) */
static void mac_256x256(uint64_t *acc, const uint64_t *a, const uint64_t *b) {
    uint64_t prod[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 t = (u128)a[i] * b[j] + prod[i + j] + carry;
            prod[i + j] = (uint64_t)t;
            carry = t >> 64;
        }
        prod[i + 4] = (uint64_t)carry;
    }
    u128 carry = 0;
    for (int k = 0; k < 8; k++) {
        u128 t = (u128)acc[k] + prod[k] + carry;
        acc[k] = (uint64_t)t;
        carry = t >> 64;
    }
    acc[8] += (uint64_t)carry;
}

/* Evaluate sparse linear combinations.
 *
 *   inputs / aux : assignments, 4 u64 limbs (LE) per value
 *   offsets      : n_cons + 1 term offsets
 *   kinds        : per term, 0 = input variable, 1 = aux variable
 *   indices      : per term, variable index
 *   coeffs       : per term, 4 u64 limbs (LE)
 *   out          : n_cons * 9 u64 limbs (LE), unreduced accumulators
 */
void lc_eval(const uint64_t *inputs, const uint64_t *aux,
             const uint32_t *offsets, const uint8_t *kinds,
             const uint32_t *indices, const uint64_t *coeffs,
             uint64_t *out, uint32_t n_cons) {
    for (uint32_t c = 0; c < n_cons; c++) {
        uint64_t *acc = out + (size_t)c * 9;
        memset(acc, 0, 9 * sizeof(uint64_t));
        for (uint32_t t = offsets[c]; t < offsets[c + 1]; t++) {
            const uint64_t *val =
                (kinds[t] == 0 ? inputs : aux) + (size_t)indices[t] * 4;
            mac_256x256(acc, val, coeffs + (size_t)t * 4);
        }
    }
}

/* Reduce a 9-limb accumulator mod a 255-bit modulus p, in place.
 *
 *   p_limbs : p as 4 u64 limbs (LE); 2^254 < p < 2^255
 *   rk      : 4 x 4 u64 limbs: 2^(64k) mod p for k = 5..8
 *   mu      : 2 u64 limbs: floor(2^322 / p)  (68 bits)
 *
 * Stage 1 — top-limb folding: t * 2^(64k) === t * rk[k-5] (mod p) removes
 * limbs 8..5 (each fold adds < 2^64 * p at base 0, touching limbs 0..4
 * plus a small carry into limb 5; 3 passes clear limbs 5..8 definitively),
 * leaving v < 2^256 + 4 * 2^64 * p + 4p < 2^322.
 *
 * Stage 2 — Barrett: a = v >> 254 (< 2^68), q = (a * mu) >> 68.  Standard
 * bounds give q <= floor(v/p) <= q + 3, so after v -= q*p at most 3
 * conditional subtractions of p remain (v < 4p needs limb 4 = 1 bit). */
static void reduce_mod_p(uint64_t *acc, const uint64_t *p_limbs,
                         const uint64_t *rk, const uint64_t *mu) {
    for (int pass = 0; pass < 3; pass++) {
        int any = 0;
        for (int k = 8; k >= 5; k--) {
            uint64_t t = acc[k];
            if (!t) continue;
            any = 1;
            acc[k] = 0;
            const uint64_t *R = rk + (size_t)(k - 5) * 4;
            u128 carry = 0;
            for (int j = 0; j < 4; j++) {
                u128 v = (u128)t * R[j] + acc[j] + carry;
                acc[j] = (uint64_t)v;
                carry = v >> 64;
            }
            for (int j = 4; carry && j < 9; j++) {
                u128 v = (u128)acc[j] + (uint64_t)carry;
                acc[j] = (uint64_t)v;
                carry = v >> 64;
            }
        }
        if (!any) break;
    }
    /* a = v >> 254 (2 limbs, < 2^68) */
    uint64_t a0 = (acc[3] >> 62) | (acc[4] << 2);
    uint64_t a1 = (acc[4] >> 62) | (acc[5] << 2);
    /* P = a * mu (a, mu < 2^68); q = P >> 68 (< 2^68) */
    u128 t0 = (u128)a0 * mu[0];
    u128 t1 = (u128)a0 * mu[1] + (u128)a1 * mu[0] + (uint64_t)(t0 >> 64);
    u128 t2 = (u128)a1 * mu[1] + (uint64_t)(t1 >> 64);
    uint64_t P1 = (uint64_t)t1, P2 = (uint64_t)t2, P3 = (uint64_t)(t2 >> 64);
    uint64_t q0 = (P1 >> 4) | (P2 << 60);
    uint64_t q1 = (P2 >> 4) | (P3 << 60);
    /* qp = q * p (6 limbs) */
    uint64_t qp[6] = {0};
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
        u128 v = (u128)q0 * p_limbs[j] + qp[j] + carry;
        qp[j] = (uint64_t)v;
        carry = v >> 64;
    }
    qp[4] = (uint64_t)carry;
    carry = 0;
    for (int j = 0; j < 4; j++) {
        u128 v = (u128)q1 * p_limbs[j] + qp[j + 1] + carry;
        qp[j + 1] = (uint64_t)v;
        carry = v >> 64;
    }
    qp[5] = (uint64_t)carry;
    /* v -= q*p */
    u128 borrow = 0;
    for (int j = 0; j < 6; j++) {
        u128 v = (u128)acc[j] - qp[j] - (uint64_t)borrow;
        acc[j] = (uint64_t)v;
        borrow = (v >> 64) ? 1 : 0;
    }
    /* v < 4p: up to 3 conditional subtractions (limb 4 holds bit 256) */
    for (int iter = 0; iter < 4; iter++) {
        int ge = 1; /* acc[0..4] >= p ? */
        if (acc[4] == 0) {
            for (int j = 3; j >= 0; j--) {
                if (acc[j] > p_limbs[j]) { ge = 1; break; }
                if (acc[j] < p_limbs[j]) { ge = 0; break; }
            }
        }
        if (!ge) break;
        borrow = 0;
        for (int j = 0; j < 4; j++) {
            u128 v = (u128)acc[j] - p_limbs[j] - (uint64_t)borrow;
            acc[j] = (uint64_t)v;
            borrow = (v >> 64) ? 1 : 0;
        }
        acc[4] -= (uint64_t)borrow;
    }
}

/* lc_eval + modular reduction + packed-byte output in one pass.
 *
 * Emits each constraint's LC value mod p as `nbytes` little-endian bytes
 * (the exact `LimbField.pack_std` wire format the device step unpacks), so
 * the batched prover's a/b/c encode path never touches Python bigints. */
void lc_eval_mod(const uint64_t *inputs, const uint64_t *aux,
                 const uint32_t *offsets, const uint8_t *kinds,
                 const uint32_t *indices, const uint64_t *coeffs,
                 const uint64_t *p_limbs, const uint64_t *rk,
                 const uint64_t *mu,
                 uint8_t *out, uint32_t nbytes, uint32_t n_cons) {
    for (uint32_t c = 0; c < n_cons; c++) {
        uint64_t acc[9];
        memset(acc, 0, sizeof acc);
        for (uint32_t t = offsets[c]; t < offsets[c + 1]; t++) {
            const uint64_t *val =
                (kinds[t] == 0 ? inputs : aux) + (size_t)indices[t] * 4;
            mac_256x256(acc, val, coeffs + (size_t)t * 4);
        }
        reduce_mod_p(acc, p_limbs, rk, mu);
        uint8_t *row = out + (size_t)c * nbytes;
        for (uint32_t b = 0; b < nbytes; b++)
            row[b] = b < 32 ? (uint8_t)(acc[b >> 3] >> ((b & 7) * 8)) : 0;
    }
}

/* ------------------------------------------------------------------ FFI
 * parity exports (reference: bellman/src/lib.rs:156-201). */

void test_bellman(void) { /* healthcheck no-op (lib.rs:157-159) */ }

/* 10-worker counting smoke test (lib.rs:180-201), single-threaded here —
 * host threading belongs to the Python layer. */
uint64_t process(void) {
    uint64_t total = 0;
    for (int t = 0; t < 10; t++) {
        volatile uint64_t x = 0;
        for (int i = 0; i < 5000000; i++) x++;
        total += x;
    }
    return total;
}
