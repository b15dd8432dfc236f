// Rodinia bfs: level-synchronous frontier expansion.  Threads claim
// unvisited neighbors with atomicCAS on the visited flags (inactive
// threads CAS a past-the-end slot with a compare value no 0/1 flag can
// match), winners publish dist and the next frontier, and the block
// counts its wins with __syncthreads_count into the host stop flag.
// One launch per BFS level, driven by the host LaunchChain.
#define N 64
#define DEG 4

__constant__ int edges[N * DEG];

__global__ void bfs_frontier(const int* frontier, int* visited, int* nxt,
                             int* dist, int* active, const int* level) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    int lvl = level[0];
    int in_f = frontier[t] == 1;
    int won_any = 0;
    for (int k = 0; k < DEG; k++) {
        int nbr = edges[t * DEG + k];
        int attempt = in_f && nbr < N;
        int old = atomicCAS(&visited[attempt ? nbr : N],
                            attempt ? 0 : -1, 1);
        int won = attempt && old == 0;
        if (won) {
            nxt[nbr] = 1;
            dist[nbr] = lvl + 1;
        }
        won_any = won_any || won;
    }
    int nwin = __syncthreads_count(won_any);
    if (threadIdx.x == 0) {
        atomicAdd(&active[0], nwin);
    }
}
