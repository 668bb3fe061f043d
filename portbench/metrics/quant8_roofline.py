"""quant8's share of its byte bound over the traced exchanges: the bytes
a float32 round trip needs (float32 in, int8 and one float32 scale a row
out, and back, `roofline.quant8_bytes`) / 3.35e12 over the device time of
the quantize_grouped and dequantize_grouped kernels."""
from portbench import roofline


def _is_q8(name):
    return "quantize_grouped" in name


def read(run):
    rec = run.record
    n = sum(1 for name, _, _, a in rec.spans
            if name == "exchange" and a.get("traced"))
    if rec.trace is None or n == 0:
        return None
    t = rec.trace.device_time_s(_is_q8)
    if t <= 0:
        return None
    q, dq = roofline.quant8_bytes(rec.facts["q8_elements"],
                                  rec.facts["q8_rows"])
    return 100.0 * n * (q + dq) / roofline.HBM_BYTES / t
