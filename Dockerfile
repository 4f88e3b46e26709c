# Container image for the airspace-tpu CLI (the reference ships a debian
# multistage Dockerfile for its meson-built C binary; this is the JAX
# analog).  CPU JAX by default — swap the jax extra for JAX's CUDA 12
# plugin (`jax[cuda12]`) when building for NVIDIA GPU hosts (H100).
FROM python:3.12-slim AS build
WORKDIR /src
COPY pyproject.toml README.md ./
COPY airs_compression_tpu ./airs_compression_tpu
RUN pip install --no-cache-dir build && python -m build --wheel

FROM python:3.12-slim
COPY --from=build /src/dist/*.whl /tmp/
RUN pip install --no-cache-dir /tmp/*.whl "jax[cpu]" xxhash \
    && rm /tmp/*.whl
ENTRYPOINT ["airspace-tpu"]
