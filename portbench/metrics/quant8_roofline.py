"""quant8's share of its byte bound over the traced exchanges: the bytes
a float32 round trip needs (float32 in, int8 and one float32 scale a row
out, and back, `roofline.quant8_bytes`) at every hop of each exchange
(one flat, two through fog cells: the edge hop and the cloud hop each
quantise every island's delta) / 3.35e12 over the device time of the
quantize_grouped and dequantize_grouped kernels."""
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
    hops = n * rec.facts["q8_hops"]
    return 100.0 * hops * (q + dq) / roofline.HBM_BYTES / t
