// Rodinia pathfinder: row-wavefront dynamic programming.  One launch
// per wall row (host chain ping-pongs src/dst): stage the previous row
// into shared with a halo, barrier, 3-neighbor min plus this row's
// weight.
#define COLS 256
#define BLOCK 64

__global__ void pathfinder(const int* wall, const int* src, int* dst,
                           const int* row) {
    __shared__ int s[BLOCK + 2];
    int tid = threadIdx.x;
    int col = blockIdx.x * BLOCK + tid;
    s[tid + 1] = src[max(0, min(col, COLS - 1))];
    if (tid == 0) {
        s[0] = src[max(0, min(col - 1, COLS - 1))];
    }
    if (tid == BLOCK - 1) {
        s[BLOCK + 1] = src[max(0, min(col + 1, COLS - 1))];
    }
    __syncthreads();
    int r = row[0];
    int best = min(min(s[tid], s[tid + 1]), s[tid + 2]);
    int v = wall[r * COLS + max(0, min(col, COLS - 1))] + best;
    if (col < COLS) {
        dst[col] = v;
    }
}
