"""Time conversions, epoch 2000-01-01T00:00Z (mirrors time2jsec.c,
jsec2time.c; conversion logic jurassic.c:1204-1221).

The port's own copy of ``jurassic_tpu/cli/timeconv.py``.
"""
from __future__ import annotations

import calendar
import math
import sys
import time as _time

from ._common import cli_main, die

_EPOCH = calendar.timegm((2000, 1, 1, 0, 0, 0))


def time2jsec(year: int, mon: int, day: int, hour: int, minute: int,
              sec: int, remain: float) -> float:
    return calendar.timegm((year, mon, day, hour, minute, sec)) - _EPOCH + remain


def jsec2time(jsec: float):
    t = _time.gmtime(int(jsec) + _EPOCH)
    remain = jsec - math.floor(jsec)
    return (t.tm_year, t.tm_mon, t.tm_mday, t.tm_hour, t.tm_min, t.tm_sec,
            remain)


@cli_main
def time2jsec_main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 8:
        die("Give parameters: <year> <mon> <day> <hour> <min> <sec> <remain>")
    print("%.2f" % time2jsec(int(argv[1]), int(argv[2]), int(argv[3]),
                             int(argv[4]), int(argv[5]), int(argv[6]),
                             float(argv[7])))
    return 0


@cli_main
def jsec2time_main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) < 2:
        die("Give parameters: <jsec>")
    year, mon, day, hour, minute, sec, remain = jsec2time(float(argv[1]))
    print("%d %d %d %d %d %d %g" % (year, mon, day, hour, minute, sec, remain))
    return 0


if __name__ == "__main__":
    sys.exit(time2jsec_main())
