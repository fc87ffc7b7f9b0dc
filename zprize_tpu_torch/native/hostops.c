/* Native host-side helpers for the TPU prover runtime.
 *
 * The reference keeps its host runtime in C++ (mini-Caffe scheduler, blst
 * bigint, CPU MSM collect). On TPU, XLA owns scheduling and the device owns
 * the O(n) math, so the only host hot path left is the plookup
 * `combine_split` bucketing (order-sensitive, dict-based — awkward to
 * vectorize) which runs once per proof over n 256-bit values
 * (lookup/multiset.rs:117-174 semantics).
 *
 * Input: t and f as (n, 32)-byte little-endian rows (uint8 contiguous).
 * Output: h1 and h2 buffers (same shape), filled per combine_split:
 *   bucket by value in order of first appearance in t, count occurrences
 *   in t and f, emit floor(c/2) copies to both halves, odd leftovers
 *   alternate even/odd starting with even.
 *
 * Exposed via ctypes (no pybind11 in this image).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define KEY_BYTES 32

typedef struct {
    uint8_t key[KEY_BYTES];
    int64_t count;
    int64_t order;     /* first-appearance index */
    int64_t next;      /* hash chain */
} entry_t;

typedef struct {
    entry_t *entries;
    int64_t n_entries;
    int64_t cap;
    int64_t *table;    /* hash buckets -> entry index (or -1) */
    int64_t table_size;
} map_t;

static uint64_t hash_key(const uint8_t *k) {
    /* FNV-1a over 32 bytes */
    uint64_t h = 1469598103934665603ULL;
    for (int i = 0; i < KEY_BYTES; i++) {
        h ^= k[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static map_t *map_new(int64_t cap_hint) {
    map_t *m = (map_t *)malloc(sizeof(map_t));
    m->cap = cap_hint > 16 ? cap_hint : 16;
    m->entries = (entry_t *)malloc(sizeof(entry_t) * m->cap);
    m->n_entries = 0;
    m->table_size = 1;
    while (m->table_size < 2 * m->cap) m->table_size <<= 1;
    m->table = (int64_t *)malloc(sizeof(int64_t) * m->table_size);
    for (int64_t i = 0; i < m->table_size; i++) m->table[i] = -1;
    return m;
}

static void map_free(map_t *m) {
    free(m->entries);
    free(m->table);
    free(m);
}

/* returns entry index; creates if missing (when create != 0), else -1 */
static int64_t map_find(map_t *m, const uint8_t *key, int create) {
    uint64_t h = hash_key(key) & (uint64_t)(m->table_size - 1);
    int64_t idx = m->table[h];
    while (idx >= 0) {
        if (memcmp(m->entries[idx].key, key, KEY_BYTES) == 0) return idx;
        idx = m->entries[idx].next;
    }
    if (!create) return -1;
    if (m->n_entries == m->cap) return -2; /* caller sized cap correctly */
    idx = m->n_entries++;
    memcpy(m->entries[idx].key, key, KEY_BYTES);
    m->entries[idx].count = 0;
    m->entries[idx].order = idx;
    m->entries[idx].next = m->table[h];
    m->table[h] = idx;
    return idx;
}

/* returns 0 on success, -1 if an f element is missing from t */
int combine_split(const uint8_t *t, const uint8_t *f, int64_t n,
                  uint8_t *h1_out, uint8_t *h2_out) {
    map_t *m = map_new(n);
    for (int64_t i = 0; i < n; i++) {
        int64_t e = map_find(m, t + i * KEY_BYTES, 1);
        if (e < 0) { map_free(m); return -2; }
        m->entries[e].count++;
    }
    for (int64_t i = 0; i < n; i++) {
        int64_t e = map_find(m, f + i * KEY_BYTES, 0);
        if (e < 0) { map_free(m); return -1; }
        m->entries[e].count++;
    }
    int64_t e_pos = 0, o_pos = 0;
    int parity = 0;
    for (int64_t e = 0; e < m->n_entries; e++) {  /* insertion order */
        int64_t c = m->entries[e].count;
        int64_t half = c / 2;
        for (int64_t k = 0; k < half; k++) {
            memcpy(h1_out + (e_pos++) * KEY_BYTES, m->entries[e].key,
                   KEY_BYTES);
            memcpy(h2_out + (o_pos++) * KEY_BYTES, m->entries[e].key,
                   KEY_BYTES);
        }
        if (c & 1) {
            if (parity == 1) {
                memcpy(h2_out + (o_pos++) * KEY_BYTES, m->entries[e].key,
                       KEY_BYTES);
                parity = 0;
            } else {
                memcpy(h1_out + (e_pos++) * KEY_BYTES, m->entries[e].key,
                       KEY_BYTES);
                parity = 1;
            }
        }
    }
    map_free(m);
    return 0;
}
