"""ctypes binding of the SIMD CPU Adam library (``csrc/cpu_adam.cpp``).

The port's counterpart of ``deepspeed_tpu/ops/native/cpu_adam.py:18-194``
over contiguous CPU tensors (``data_ptr()``) where the JAX package passes
numpy arrays: Adam/AdamW, LAMB, ``adam_step_ex`` (gradients read in their
wire dtype, fp32 or bf16, with ``grad_scale`` folded into the read and
the bf16 copy of the updated parameters written in the same pass), the
bf16 <-> fp32 converters and ``l2_norm``. ``load()`` builds the library
at first use; a failed build raises.
"""

import ctypes
import math

import torch

from deepspeed_tpu_torch.ops.native.builder import CPUAdamBuilder

_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_INT = ctypes.c_int


def _ptr(t, dtype=torch.float32):
    """The address of a contiguous CPU tensor of ``dtype`` (bf16 and
    int16/uint16 tensors are all 16-bit words to the library)."""
    if not (torch.is_tensor(t) and t.device.type == "cpu"
            and t.is_contiguous()):
        raise TypeError("the CPU Adam library takes contiguous CPU tensors")
    ok = (t.dtype == dtype) if dtype == torch.float32 else \
        t.dtype in (torch.bfloat16, torch.int16, torch.uint16)
    if not ok:
        raise TypeError(f"need {dtype}, got {t.dtype}")
    return ctypes.c_void_p(t.data_ptr())


def _same_size(*ts):
    n = ts[0].numel()
    if any(t.numel() != n for t in ts):
        raise ValueError(f"sizes differ: {[t.numel() for t in ts]}")
    return n


class NativeCpuAdam:
    def __init__(self, lib):
        self.lib = lib
        adam_tail = [_I64, _I64, _F, _F, _F, _F, _F, _INT, _INT]
        lib.ds_adam_step.argtypes = [_P] * 4 + adam_tail
        lib.ds_adam_step.restype = None
        lib.ds_adam_step_multi.argtypes = [_P] * 5 + adam_tail
        lib.ds_adam_step_multi.restype = None
        lamb_tail = [_I64, _I64, _F, _F, _F, _F, _F, _F, _F, _INT]
        lib.ds_lamb_step.argtypes = [_P] * 5 + lamb_tail
        lib.ds_lamb_step.restype = None
        lib.ds_adam_step_ex.argtypes = [_P, _P, _INT, _F] + [_P] * 3 \
            + adam_tail
        lib.ds_adam_step_ex.restype = None
        lib.ds_lamb_step_ex.argtypes = [_P, _P, _INT, _F] + [_P] * 4 \
            + lamb_tail
        lib.ds_lamb_step_ex.restype = None
        lib.ds_fp32_to_bf16.argtypes = [_P, _P, _I64]
        lib.ds_fp32_to_bf16.restype = None
        lib.ds_bf16_to_fp32.argtypes = [_P, _P, _I64]
        lib.ds_bf16_to_fp32.restype = None
        lib.ds_l2_norm_sq.argtypes = [_P, _I64]
        lib.ds_l2_norm_sq.restype = ctypes.c_double
        lib.ds_adam_num_threads.argtypes = []
        lib.ds_adam_num_threads.restype = ctypes.c_int

    @staticmethod
    def _grad(g):
        """(address, is_bf16) of fp32 or bf16 gradients; fp16 bits are
        not bf16 and are refused (widen them first)."""
        if g.dtype == torch.float32:
            return _ptr(g), 0
        return _ptr(g, torch.bfloat16), 1

    def adam_step(self, params, grads, exp_avg, exp_avg_sq, step, lr,
                  beta1, beta2, eps, weight_decay, adamw_mode,
                  bias_correction=True):
        n = _same_size(params, grads, exp_avg, exp_avg_sq)
        self.lib.ds_adam_step(
            _ptr(params), _ptr(grads), _ptr(exp_avg), _ptr(exp_avg_sq), n,
            int(step), float(lr), float(beta1), float(beta2), float(eps),
            float(weight_decay), int(bool(adamw_mode)),
            int(bool(bias_correction)))

    def adam_step_multi(self, params, grads, exp_avg, exp_avg_sq, step, lr,
                        beta1, beta2, eps, weight_decay, adamw_mode,
                        bias_correction=True):
        """One call for a whole leaf list (OpenMP spans every leaf)."""
        n = len(params)
        if not n == len(grads) == len(exp_avg) == len(exp_avg_sq):
            raise ValueError("leaf lists differ in length")
        for group in zip(params, grads, exp_avg, exp_avg_sq):
            _same_size(*group)

        def ptrs(group):
            return (_P * n)(*(_ptr(t) for t in group))
        sizes = (_I64 * n)(*(t.numel() for t in params))
        self.lib.ds_adam_step_multi(
            ptrs(params), ptrs(grads), ptrs(exp_avg), ptrs(exp_avg_sq),
            sizes, n, int(step), float(lr), float(beta1), float(beta2),
            float(eps), float(weight_decay), int(bool(adamw_mode)),
            int(bool(bias_correction)))

    def adam_step_ex(self, params, grads, exp_avg, exp_avg_sq, step, lr,
                     beta1, beta2, eps, weight_decay, adamw_mode,
                     bias_correction=True, grad_scale=1.0, params_bf16=None):
        """One pass: ``grads`` (fp32 or bf16) times ``grad_scale``, the
        moments and fp32 ``params`` updated in place, and the bf16 copy
        of the updated params written to ``params_bf16`` when given."""
        n = _same_size(params, grads, exp_avg, exp_avg_sq)
        gptr, gbf16 = self._grad(grads)
        out = None
        if params_bf16 is not None:
            _same_size(params, params_bf16)
            out = _ptr(params_bf16, torch.bfloat16)
        self.lib.ds_adam_step_ex(
            _ptr(params), gptr, gbf16, float(grad_scale), _ptr(exp_avg),
            _ptr(exp_avg_sq), out, n, int(step), float(lr), float(beta1),
            float(beta2), float(eps), float(weight_decay),
            int(bool(adamw_mode)), int(bool(bias_correction)))

    def lamb_step(self, params, grads, exp_avg, exp_avg_sq, step, lr,
                  beta1, beta2, eps, weight_decay, max_coeff, min_coeff,
                  bias_correction=True, update_buf=None):
        n = _same_size(params, grads, exp_avg, exp_avg_sq)
        if update_buf is None:
            update_buf = torch.empty_like(params)
        self.lib.ds_lamb_step(
            _ptr(params), _ptr(grads), _ptr(exp_avg), _ptr(exp_avg_sq),
            _ptr(update_buf), n, int(step), float(lr), float(beta1),
            float(beta2), float(eps), float(weight_decay), float(max_coeff),
            float(min_coeff), int(bool(bias_correction)))

    def lamb_step_ex(self, params, grads, exp_avg, exp_avg_sq, step, lr,
                     beta1, beta2, eps, weight_decay, max_coeff, min_coeff,
                     bias_correction=True, grad_scale=1.0, params_bf16=None,
                     update_buf=None):
        n = _same_size(params, grads, exp_avg, exp_avg_sq)
        gptr, gbf16 = self._grad(grads)
        if update_buf is None:
            update_buf = torch.empty_like(params)
        out = None
        if params_bf16 is not None:
            _same_size(params, params_bf16)
            out = _ptr(params_bf16, torch.bfloat16)
        self.lib.ds_lamb_step_ex(
            _ptr(params), gptr, gbf16, float(grad_scale), _ptr(exp_avg),
            _ptr(exp_avg_sq), _ptr(update_buf), out, n, int(step), float(lr),
            float(beta1), float(beta2), float(eps), float(weight_decay),
            float(max_coeff), float(min_coeff), int(bool(bias_correction)))

    def fp32_to_bf16(self, src, dst=None):
        if dst is None:
            dst = torch.empty(src.shape, dtype=torch.bfloat16)
        self.lib.ds_fp32_to_bf16(_ptr(src), _ptr(dst, torch.bfloat16),
                                 _same_size(src, dst))
        return dst

    def bf16_to_fp32(self, src, dst=None):
        if dst is None:
            dst = torch.empty(src.shape, dtype=torch.float32)
        self.lib.ds_bf16_to_fp32(_ptr(src, torch.bfloat16), _ptr(dst),
                                 _same_size(src, dst))
        return dst

    def l2_norm(self, t):
        return math.sqrt(self.lib.ds_l2_norm_sq(_ptr(t), t.numel()))

    def num_threads(self):
        return self.lib.ds_adam_num_threads()


def load():
    """Build (at first use) and load the library; raises when it cannot
    be built."""
    global _lib
    if _lib is None:
        _lib = NativeCpuAdam(CPUAdamBuilder().load())
    return _lib
