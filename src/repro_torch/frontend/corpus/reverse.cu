// Paper Listing 3 (dynamicReverse): dynamic shared memory and the
// barrier that splits the kernel into a load stage and a store stage.
#define BD 512

__global__ void reverse(int* d) {
    extern __shared__ int s[];
    int t = threadIdx.x;
    int tr = BD - t - 1;
    s[t] = d[t];
    __syncthreads();
    d[t] = s[tr];
}
