from .ops import mlstm
from .ref import mlstm_chunked, mlstm_decode_step, mlstm_sequential

__all__ = ["mlstm", "mlstm_chunked", "mlstm_decode_step", "mlstm_sequential"]
