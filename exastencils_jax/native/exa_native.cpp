// exa_native: C++ runtime services for the JAX ExaStencils build.
//
// The reference emits these as *generated* C++ into every solver project:
//   - field layout index algebra  (field/ir/IR_FieldLayout.scala:30-102:
//     per-dim segments [pad | ghost | dupLeft | inner | dupRight | ghost
//     | pad] with named index bounds)
//   - rectangular domain partitioning + neighbor connectivity
//     (domain/ir/IR_InitGeneratedDomain.scala:37-71,
//     domain/ir/IR_ConnectFragments.scala: fragment position from rank,
//     local/remote neighbor tables, iteration offsets at physical
//     boundaries)
//   - halo pack intervals (communication/ir/IR_PackInfo.scala:12-66:
//     ghost/duplicate send/recv index boxes per direction)
//   - golden-output comparison (Testing/run_test.py:12-42)
//
// Here they are a small hand-written library with a C ABI consumed via
// ctypes (exastencils_jax.native).  The JAX/XLA compute path never calls
// into this at trace time; it serves setup (host-side partitioning and
// interval computation) and tooling.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Layout index algebra.  For one dimension with segments
//   [pad | ghost | dupL | inner | dupR | ghost | pad]
// compute the named bounds the reference exposes via idxById:
//   PLB GLB DLB IB IE DRE GRE PRE  (begin of each segment + total end)
// out: int32[9] = {PLB, GLB, DLB, IB, IE, DRE, GRE, PRE, total}
void exa_layout_bounds_1d(int32_t pad, int32_t ghost, int32_t dupL,
                          int32_t inner, int32_t dupR, int32_t* out) {
  int32_t plb = 0;
  int32_t glb = plb + pad;
  int32_t dlb = glb + ghost;
  int32_t ib = dlb + dupL;
  int32_t ie = ib + inner;
  int32_t dre = ie + dupR;
  int32_t gre = dre + ghost;
  int32_t pre = gre + pad;
  out[0] = plb; out[1] = glb; out[2] = dlb; out[3] = ib; out[4] = ie;
  out[5] = dre; out[6] = gre; out[7] = pre; out[8] = pre;
}

// ---------------------------------------------------------------------------
// Rectangular domain partitioning (IR_InitGeneratedDomain):
// fragments are laid out fragment-major inside blocks; the global
// fragment index along dim d is  block_d * fragsPerBlock_d + frag_d.
// For fragment id `fid` (row-major over dims, x fastest) compute:
//   pos[ndim]        : per-dim fragment coordinate
//   neighbors[2*ndim]: fragment id of the -x,+x,-y,+y,... neighbor or -1
//   iterOffBegin/End[ndim]: 1/-1 at physical boundaries else 0
//     (IR_IV_IterationOffsetBegin/End resolveDefValue + ConnectFragments)
void exa_fragment_connectivity(int32_t ndim, const int32_t* fragsTotal,
                               int32_t fid, int32_t* pos, int32_t* neighbors,
                               int32_t* iterOffBegin, int32_t* iterOffEnd) {
  int32_t rem = fid;
  for (int d = 0; d < ndim; ++d) {
    pos[d] = rem % fragsTotal[d];
    rem /= fragsTotal[d];
  }
  for (int d = 0; d < ndim; ++d) {
    int32_t stride = 1;
    for (int dd = 0; dd < d; ++dd) stride *= fragsTotal[dd];
    neighbors[2 * d + 0] = pos[d] > 0 ? fid - stride : -1;
    neighbors[2 * d + 1] = pos[d] < fragsTotal[d] - 1 ? fid + stride : -1;
    iterOffBegin[d] = pos[d] == 0 ? 1 : 0;
    iterOffEnd[d] = pos[d] == fragsTotal[d] - 1 ? -1 : 0;
  }
}

// Rank -> fragment-id list for block-wise ownership: block index = rank,
// each block owns fragsPerBlock fragments (IR_InitGeneratedDomain:40-48).
// Returns number of fragments written into `out` (capacity must be
// prod(fragsPerBlock)).
int32_t exa_rank_fragments(int32_t ndim, const int32_t* blocks,
                           const int32_t* fragsPerBlock, int32_t rank,
                           int32_t* out) {
  if (ndim < 1 || ndim > 3) return -1;  // scratch arrays below are size 3
  int32_t bpos[3] = {0, 0, 0};
  int32_t rem = rank;
  for (int d = 0; d < ndim; ++d) {
    bpos[d] = rem % blocks[d];
    rem /= blocks[d];
  }
  int32_t fragsTotal[3];
  for (int d = 0; d < ndim; ++d) fragsTotal[d] = blocks[d] * fragsPerBlock[d];
  int32_t count = 1;
  for (int d = 0; d < ndim; ++d) count *= fragsPerBlock[d];
  for (int32_t i = 0; i < count; ++i) {
    int32_t lrem = i;
    int32_t gpos[3];
    for (int d = 0; d < ndim; ++d) {
      int32_t lp = lrem % fragsPerBlock[d];
      lrem /= fragsPerBlock[d];
      gpos[d] = bpos[d] * fragsPerBlock[d] + lp;
    }
    int32_t gid = 0;
    int32_t stride = 1;
    for (int d = 0; d < ndim; ++d) {
      gid += gpos[d] * stride;
      stride *= fragsTotal[d];
    }
    out[i] = gid;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Pack intervals (IR_PackInfo{Ghost,Duplicate}{Send,Recv}): index boxes
// [begin, end) per dim for a neighbor direction dir in {-1,0,1}^ndim.
// bounds: int32[ndim][9] from exa_layout_bounds_1d.
//   kind: 0 = ghost, 1 = duplicate
//   send: 1 = pack (read) box, 0 = unpack (write) box
// Ghost send reads the inner layers adjacent to the boundary; ghost recv
// writes the ghost layers.  Duplicate send reads the dup layer; dup recv
// writes the opposite copy's dup layer.
void exa_pack_interval(int32_t ndim, const int32_t* bounds9, const int32_t* dir,
                       int32_t kind, int32_t send, int32_t* beginOut,
                       int32_t* endOut) {
  for (int d = 0; d < ndim; ++d) {
    const int32_t* b = bounds9 + 9 * d;
    int32_t GLB = b[1], DLB = b[2], IB = b[3], IE = b[4], DRE = b[5],
            GRE = b[6];
    int32_t ghost = DLB - GLB;
    if (dir[d] == 0) {  // full non-ghost extent orthogonal to direction
      beginOut[d] = DLB;
      endOut[d] = DRE;
    } else if (kind == 0) {  // ghost
      if (send) {
        // read innermost `ghost` layers next to the dup layer
        if (dir[d] < 0) { beginOut[d] = DLB; endOut[d] = DLB + ghost; }
        else            { beginOut[d] = DRE - ghost; endOut[d] = DRE; }
      } else {
        if (dir[d] < 0) { beginOut[d] = GLB; endOut[d] = DLB; }
        else            { beginOut[d] = DRE; endOut[d] = GRE; }
      }
    } else {  // duplicate
      if (dir[d] < 0) { beginOut[d] = DLB; endOut[d] = IB; }
      else            { beginOut[d] = IE; endOut[d] = DRE; }
    }
  }
}

// ---------------------------------------------------------------------------
// Golden-output comparison (Testing/run_test.py:12-42): line-by-line,
// numeric lines compare with |a-b| <= eps.  Returns 0 on match, the
// (1-based) first differing line otherwise, -1/-2 on unreadable files,
// -3 on line-count mismatch.
static int read_lines(const char* path, char*** out_lines, int* out_n) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int cap = 256, n = 0;
  char** lines = (char**)malloc(cap * sizeof(char*));
  char buf[4096];
  while (fgets(buf, sizeof buf, f)) {
    size_t len = strlen(buf);
    while (len && (buf[len - 1] == '\n' || buf[len - 1] == '\r' ||
                   buf[len - 1] == ' ' || buf[len - 1] == '\t'))
      buf[--len] = 0;
    if (n == cap) {
      cap *= 2;
      lines = (char**)realloc(lines, cap * sizeof(char*));
    }
    lines[n++] = strdup(buf);
  }
  fclose(f);
  *out_lines = lines;
  *out_n = n;
  return 0;
}

int32_t exa_check_results(const char* got_path, const char* expect_path,
                          double eps) {
  char **got = nullptr, **exp = nullptr;
  int ng = 0, ne = 0;
  if (read_lines(got_path, &got, &ng) != 0) return -1;
  if (read_lines(expect_path, &exp, &ne) != 0) return -2;
  int32_t result = 0;
  if (ng != ne) {
    result = -3;
  } else {
    for (int i = 0; i < ng && !result; ++i) {
      if (strcmp(got[i], exp[i]) == 0) continue;
      char *e1 = nullptr, *e2 = nullptr;
      double a = strtod(got[i], &e1);
      double b = strtod(exp[i], &e2);
      bool numeric = e1 && *e1 == 0 && e2 && *e2 == 0 && *got[i] && *exp[i];
      if (!numeric || std::fabs(a - b) > eps) result = i + 1;
    }
  }
  for (int i = 0; i < ng; ++i) free(got[i]);
  for (int i = 0; i < ne; ++i) free(exp[i]);
  free(got);
  free(exp);
  return result;
}

}  // extern "C"
