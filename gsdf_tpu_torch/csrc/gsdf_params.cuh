// How the per-tree kernel templates (classified_grid.cu, point_eval.cu)
// take a tree's continuous parameters in their parametric form.
//
// A parametric gsdf_tree.cuh (gsdf_tpu_torch/codegen/cuda.py) defines
// GSDF_PARAMETRIC, GSDF_NPARAMS and GSDF_PARAMS_BY_VALUE, and its
// gsdf_tree() takes `const float* P` first. A baked one defines none of
// them, and everything here is empty.
//
// By value (GSDF_PARAMS_BY_VALUE 1): the vector is a __grid_constant__
// kernel parameter. It sits in the kernel-parameter constant bank: the
// launch itself carries it (no upload, no synchronising call), every
// thread of a warp reads the same word, and a word at a fixed offset is an
// instruction operand much as a literal is. An OpUnion's member loop
// indexes it at run time, which the bank allows. The host entry point
// copies the caller's floats into the struct.
//
// By pointer (GSDF_PARAMS_BY_VALUE 0): for a vector too long for the
// kernel-parameter space; the caller uploads it and the kernel reads
// device memory through the read-only path.
//
// In a kernel's parameter list write GSDF_PARAMS_DECL after the last
// parameter, in its launch GSDF_PARAMS_ARG after the last argument, and
// call GSDF_TREE(x, y[, z]).
#pragma once

#ifdef GSDF_PARAMETRIC

#if GSDF_PARAMS_BY_VALUE
struct GsdfParams {
    float v[GSDF_NPARAMS];
};
#define GSDF_PARAMS_DECL , const __grid_constant__ GsdfParams gsdf_params
#define GSDF_TREE(...) gsdf_tree(gsdf_params.v, __VA_ARGS__)
#else
#define GSDF_PARAMS_DECL , const float* __restrict__ gsdf_params
#define GSDF_TREE(...) gsdf_tree(gsdf_params, __VA_ARGS__)
#endif
#define GSDF_PARAMS_ARG , gsdf_params

// 1 where the entry points take the vector as a host pointer and pass it
// by value, 0 where they take a device pointer (weak: one definition per
// template of a library).
extern "C" __attribute__((weak)) int gsdf_params_by_value() { return GSDF_PARAMS_BY_VALUE; }

#else  // baked

#define GSDF_PARAMS_DECL
#define GSDF_PARAMS_ARG
#define GSDF_TREE(...) gsdf_tree(__VA_ARGS__)

#endif
