// Host helpers of the port, loaded with ctypes (native/loader.py): the
// mapped-to-ids triple reader and the row-sparse plan kernels.
//
// The reader streams a 5-column mapped file once with hand-rolled integer
// scanning, filling preallocated numpy buffers through a two-pass (count,
// fill) interface instead of splitting every line in python.
//
// Format per line:
//   subj_id \t rel_id \t obj_id \t subj_mention_ids(space sep) \t obj_mention_ids
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (native/loader.py); no external
// dependencies.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Returns 0 on success. Counts lines with >= 3 fields and the total number
// of subject/object mention ids.
int oket_count_5col(const char* path, int64_t* n_triples, int64_t* n_subj_vals,
                    int64_t* n_obj_vals) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  const size_t BUF = 1 << 22;
  char* buf = (char*)malloc(BUF);
  if (!buf) { fclose(f); return 2; }

  int64_t triples = 0, svals = 0, ovals = 0;
  int field = 0;            // current tab-separated field index
  bool in_number = false;   // currently inside a digit run
  int64_t s_line = 0, o_line = 0;  // mention counts on this line

  auto end_line = [&](int last_field) {
    if (last_field >= 2) {
      triples++;
      // 3-col closed-KG lines duplicate cols 1/3 into the mention lists
      svals += (s_line == 0) ? 1 : s_line;
      ovals += (o_line == 0) ? 1 : o_line;
    }
    field = 0;
    s_line = o_line = 0;
  };

  size_t got;
  while ((got = fread(buf, 1, BUF, f)) > 0) {
    for (size_t i = 0; i < got; i++) {
      char c = buf[i];
      if (c >= '0' && c <= '9') {
        if (!in_number) {
          in_number = true;
          if (field == 3) s_line++;
          else if (field == 4) o_line++;
        }
      } else {
        in_number = false;
        if (c == '\t') {
          field++;
        } else if (c == '\n') {
          end_line(field);
        }
      }
    }
  }
  // last line without trailing newline
  end_line(field);
  free(buf);
  fclose(f);
  *n_triples = triples;
  *n_subj_vals = svals;
  *n_obj_vals = ovals;
  return 0;
}

// Fill preallocated buffers:
//   triples   [n_triples * 3] int32
//   s_off     [n_triples + 1] int64 (CSR offsets; s_off[0] must be 0)
//   s_val     [n_subj_vals]   int32
//   o_off     [n_triples + 1] int64
//   o_val     [n_obj_vals]    int32
// Lines with fewer than 5 fields duplicate cols 1/3 into the mention lists
// (closed-KG convention).  Returns number of triples written, or -1 on error.
int64_t oket_parse_5col(const char* path, int32_t* triples, int64_t* s_off,
                        int32_t* s_val, int64_t* o_off, int32_t* o_val) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  const size_t BUF = 1 << 22;
  char* buf = (char*)malloc(BUF);
  if (!buf) { fclose(f); return -1; }

  int64_t t = 0, si = 0, oi = 0;
  int field = 0;
  int64_t cur = -1;  // current number being scanned, -1 = none
  int32_t cols[3] = {0, 0, 0};
  int subj_count_this_line = 0, obj_count_this_line = 0;
  s_off[0] = 0;
  o_off[0] = 0;

  auto end_number = [&]() {
    if (cur < 0) return;
    if (field < 3) {
      if (field >= 0 && field <= 2) cols[field] = (int32_t)cur;
    } else if (field == 3) {
      s_val[si++] = (int32_t)cur;
      subj_count_this_line++;
    } else if (field == 4) {
      o_val[oi++] = (int32_t)cur;
      obj_count_this_line++;
    }
    cur = -1;
  };
  auto end_line = [&](int last_field) {
    if (last_field < 2) {  // blank/malformed line
      field = 0;
      cur = -1;
      subj_count_this_line = obj_count_this_line = 0;
      return;
    }
    triples[t * 3 + 0] = cols[0];
    triples[t * 3 + 1] = cols[1];
    triples[t * 3 + 2] = cols[2];
    if (subj_count_this_line == 0) { s_val[si++] = cols[0]; subj_count_this_line = 1; }
    if (obj_count_this_line == 0) { o_val[oi++] = cols[2]; obj_count_this_line = 1; }
    s_off[t + 1] = si;
    o_off[t + 1] = oi;
    t++;
    field = 0;
    cur = -1;
    subj_count_this_line = obj_count_this_line = 0;
  };

  size_t got;
  while ((got = fread(buf, 1, BUF, f)) > 0) {
    for (size_t i = 0; i < got; i++) {
      char c = buf[i];
      if (c >= '0' && c <= '9') {
        cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
      } else if (c == '\t') {
        end_number();
        field++;
      } else if (c == '\n') {
        end_number();
        end_line(field);
      } else {
        end_number();
      }
    }
  }
  end_number();
  if (field >= 2) end_line(field);
  free(buf);
  fclose(f);
  return t;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-side batch-plan kernels for the row-sparse training path.
//
// The sparse plan builder (train/sparse.py) otherwise runs numpy's
// union1d + searchsorted remaps of ~123k token ids and the gather-sum grad
// plan's sort and grouping per flagship batch.  These two kernels do the
// same with O(n + V) bitmap and counting passes; ctypes releases the GIL
// around them, so the prefetch threads build plans while the card steps.

extern "C" {

// Sorted unique ids (0 always included) + remap of `toks` into the compact
// id space.  `scratch` must hold >= vocab int32 (caller reuses it across
// calls).  Writes uids (caller capacity >= n+1) and remapped (size n).
// Returns U (number of unique ids) or -1 on bad input.
int64_t oket_unique_remap(const int32_t* toks, int64_t n, int64_t vocab,
                          int32_t* scratch, int32_t* uids, int32_t* remapped) {
  if (n < 0 || vocab <= 0) return -1;
  // pass 1: presence
  memset(scratch, 0, sizeof(int32_t) * (size_t)vocab);
  scratch[0] = 1;  // PAD always present (train/sparse.py pad contract)
  for (int64_t i = 0; i < n; i++) {
    int32_t t = toks[i];
    if (t >= 0 && t < vocab) scratch[t] = 1;
  }
  // pass 2: uids + positions (scratch becomes the lut)
  int64_t u = 0;
  for (int64_t v = 0; v < vocab; v++) {
    if (scratch[v]) {
      uids[u] = (int32_t)v;
      scratch[v] = (int32_t)u;
      u++;
    }
  }
  // pass 3: remap
  for (int64_t i = 0; i < n; i++) {
    int32_t t = toks[i];
    remapped[i] = (t >= 0 && t < vocab) ? scratch[t] : 0;
  }
  return u;
}

// Gather-sum backward plan over a remapped token matrix [R, L] (row-major,
// ids in [0, U)); equivalent of train/sparse.py build_token_grad_plan (its numpy
// branch gives the same arrays):
//   * rows stably sorted by descending non-pad length (counting sort over
//     lengths 0..L — identical to the device's length_sort_perm),
//   * non-pad positions (flat time-major index p = t*R + sorted_row)
//     grouped by id, each group packed into slots of K positions.
// Outputs (caller-allocated): pos [cap_slots*K] i32, valid [cap_slots*K]
// u8, uid [cap_slots] i32 (filled with `oob` for unused slots).  cap_slots
// must be >= U + n_nonpad/K + 1.  Scratch: >= max(U+1, L+1) + R int64.
// Returns the number of slots used, or -1 if cap_slots is too small.
int64_t oket_grad_plan(const int32_t* remapped, int64_t R, int64_t L,
                       int64_t U, int64_t K, int32_t oob,
                       int64_t cap_slots, int64_t* scratch64,
                       int32_t* pos, uint8_t* valid, int32_t* uid) {
  // lengths + counting sort by (L - len), stable  -> order[r] = original row
  // occupying sorted slot r
  int64_t* cnt = scratch64;            // max(L+1, U+1) counters
  int64_t* order = scratch64 + (U + 1 > L + 1 ? U + 1 : L + 1);
  for (int64_t b = 0; b <= L; b++) cnt[b] = 0;
  // lengths: number of nonzero ids per row (ids lead, pads trail, but count
  // defensively over the whole row to mirror (toks > 0).sum(1))
  for (int64_t r = 0; r < R; r++) {
    int64_t len = 0;
    for (int64_t c = 0; c < L; c++) len += remapped[r * L + c] != 0;
    cnt[L - len]++;
  }
  int64_t run = 0;
  for (int64_t b = 0; b <= L; b++) { int64_t c = cnt[b]; cnt[b] = run; run += c; }
  for (int64_t r = 0; r < R; r++) {
    int64_t len = 0;
    for (int64_t c = 0; c < L; c++) len += remapped[r * L + c] != 0;
    order[cnt[L - len]++] = r;
  }
  // counts per id over non-pad positions
  int64_t* idc = scratch64;  // reuse: [U+1]; order[] lives above it
  for (int64_t v = 0; v <= U; v++) idc[v] = 0;
  int64_t n_nonpad = 0;
  for (int64_t r = 0; r < R; r++) {
    const int32_t* row = remapped + order[r] * L;
    for (int64_t c = 0; c < L; c++) {
      int32_t t = row[c];
      if (t != 0) { idc[t]++; n_nonpad++; }
    }
  }
  // slot base per id: ceil(count / K) slots each
  int64_t s = 0;
  for (int64_t v = 1; v < U; v++) {  // id 0 = PAD: no slots
    int64_t c = idc[v];
    idc[v] = s;                       // becomes "next write cursor" (in positions)
    s += (c + K - 1) / K;
  }
  int64_t n_slots = s;
  if (n_slots > cap_slots) return -1;
  memset(valid, 0, (size_t)(cap_slots * K));
  for (int64_t i = 0; i < cap_slots; i++) uid[i] = oob;
  // second cursor array: write offset within the id's slot run (positions)
  int64_t* wcur = idc;  // idc[v] currently = slot base for id v
  // convert slot base -> global cell cursor (slot*K)
  for (int64_t v = 1; v < U; v++) wcur[v] *= K;
  // walk positions in time-major sorted order, append to the id's run
  for (int64_t t = 0; t < L; t++) {
    for (int64_t r = 0; r < R; r++) {
      int32_t id = remapped[order[r] * L + t];
      if (id == 0) continue;
      int64_t cell = wcur[id]++;
      // cells of an id's run are contiguous from its base; they may span
      // slots but never collide with another id's run (sized by count)
      pos[cell] = (int32_t)(t * R + r);
      valid[cell] = 1;
      uid[cell / K] = id;
    }
  }
  (void)n_nonpad;
  return n_slots;
}

}  // extern "C"
