# pcr-tpu container. The default build is the CPU backend (tests, CI,
# development); NVIDIA GPU hosts build with the JAX CUDA plugin.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/pcr-tpu
COPY . .

ARG JAX_VARIANT=cpu
# NVIDIA GPU hosts: --build-arg JAX_VARIANT="cuda12"
RUN pip install --no-cache-dir "jax[${JAX_VARIANT}]" numpy pillow pytest \
    && pip install --no-cache-dir -e .

# warm the native host kernels (g++ build is cached in the image)
RUN python -c "from pcr_tpu import native; native.available()"

CMD ["python", "-m", "pytest", "tests/", "-q"]
