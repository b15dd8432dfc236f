// Rodinia-hotspot-shaped 3-point stencil: boundary threads stage the
// halo cells into shared memory, a barrier, then the weighted sum.
#define NN 4096
#define BLOCK 128

__global__ void stencil1d(const float* x, float* y) {
    __shared__ float s[BLOCK + 2];
    int tid = threadIdx.x;
    int gid = blockIdx.x * BLOCK + tid;
    s[tid + 1] = x[max(0, min(gid, NN - 1))];
    if (tid == 0) {
        s[0] = x[max(0, min(gid - 1, NN - 1))];
    }
    if (tid == BLOCK - 1) {
        s[BLOCK + 1] = x[max(0, min(gid + 1, NN - 1))];
    }
    __syncthreads();
    float v = 0.25f * s[tid] + 0.5f * s[tid + 1] + 0.25f * s[tid + 2];
    if (gid < NN) {
        y[gid] = v;
    }
}
