"""FEM core: stiffness operators, CUDA kernels, multigrid, MGPCG, OC."""
