# Build/verify flow — the analog of the reference's Makefile
# (/root/reference/Makefile:28-54: build_emu / report / build_hw / run_*).
#
#   make native   build the C host core (libnttcore.so)
#   make test     run the suite on virtual CPU devices (the FPGA-emulator analog)
#   make smoke    run chip_smoke.py: the main path on one GPU, checked
#   make report   static per-transform analysis: HLO dump + traced op counts
#                 (the analog of `make report` -> report.html)
#   make bench    headline benchmark on a GPU (one JSON line)

CC      ?= gcc
CFLAGS  ?= -O3 -shared -fPIC -Wall -Wextra
BUILD   := build

.PHONY: all native test smoke report bench clean

all: native

native: $(BUILD)/libnttcore.so

$(BUILD)/libnttcore.so: csrc/nttcore.c
	mkdir -p $(BUILD)
	$(CC) $(CFLAGS) -o $@ $<

test: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

smoke:
	python chip_smoke.py

report:
	python -m agilex_ntt.utils.report

bench:
	python bench.py

clean:
	rm -rf $(BUILD) report_out
