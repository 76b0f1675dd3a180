// Which operand dtypes a build of a source holds. A source that
// instantiates its kernels for bf16 (code 0), fp16 (1) and fp32 (2) is
// built once per dtype with -DAPEX_DTYPE=<code> (ops/_build.py), so the
// three builds compile side by side; without the define one build holds
// all three. Each case of a C interface's dtype switch is guarded by
// APEX_HAS_DTYPE(code): a build without that dtype instantiates none of
// its kernels and returns cudaErrorInvalidValue for it.

#pragma once

#ifdef APEX_DTYPE
#define APEX_HAS_DTYPE(code) (APEX_DTYPE == (code))
#else
#define APEX_HAS_DTYPE(code) 1
#endif
