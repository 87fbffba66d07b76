"""Rematerialization in the port, for the Mamba and xLSTM archs
(jamba-1.5-large-398b with a Mamba chunk of 4 of the 16 positions, and
xlstm-125m): grads with ``remat=True`` equal ``remat=False`` bit for bit
on the CPU, autograd saves under half the bytes, and the no-grad forward
is unchanged (``test_torch_remat.py`` says how each is checked).
"""
import pytest

from test_torch_remat import check_no_grad_forward, check_remat

ARCHS = ("jamba-1.5-large-398b", "xlstm-125m")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_equal_bit_for_bit_and_save_less(arch, monkeypatch):
    check_remat(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_grad_forward_is_unchanged_by_remat(arch):
    check_no_grad_forward(arch)
