// Rodinia nw (Needleman-Wunsch): anti-diagonal wavefront.  One launch
// per diagonal `d` (host chain steps the diag counter); each cell on
// the diagonal depends only on the two previous diagonals, already
// final in global memory.  score is (N+1)x(N+1) and sim is NxN, both
// indexed flat as a CUDA author would.
#define N 32
#define PENALTY 2

__global__ void needle_nw(int* score, const int* sim, const int* diag) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    int d = diag[0];
    int lo = max(1, d - N);
    int hi = min(N, d - 1);
    int i = max(1, min(t + lo, N));
    int j = max(1, min(d - i, N));
    int dv = score[(i - 1) * (N + 1) + (j - 1)] + sim[(i - 1) * N + (j - 1)];
    int up = score[(i - 1) * (N + 1) + j] - PENALTY;
    int lf = score[i * (N + 1) + (j - 1)] - PENALTY;
    int v = max(dv, max(up, lf));
    if (t <= hi - lo) {
        score[i * (N + 1) + j] = v;
    }
}
