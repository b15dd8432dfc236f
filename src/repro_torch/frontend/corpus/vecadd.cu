// Paper Listing 1: the canonical CUDA hello-world.
// The scalar parameter `n` is bound at translation time
// (translate(..., bind={"n": 4096})), the POCL-style specializing JIT.
__global__ void vecadd(const float* a, const float* b, float* c, int n) {
    int gid = blockIdx.x * blockDim.x + threadIdx.x;
    if (gid < n) {
        c[gid] = a[gid] + b[gid];
    }
}
